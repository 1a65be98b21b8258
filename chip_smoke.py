#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``avex_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its results on lines of its own:

1. card: require CUDA; print ``nvidia-smi``'s name and power limit;
2. build: compile every CUDA source of the port with ``nvcc`` (in parallel;
   the attention sources once for each head width they are built for, 32,
   64, 80, 96 and 128, each with its general kernels for the other widths;
   the 3xTF32 backward's too; prints each kernel's registers and spills, and
   a spilling kernel fails the phase);
3. kernels: hold each kernel against its plain PyTorch twin at the shapes the
   main paths give it, in bf16 and fp32 (bf16 on the tensor-core kernels of
   ``tensor_core_attention.cu``, fp32 on them in 3xTF32,
   ``tf32x3_attention.cu``: each call's body checked, max|d| 1e-4 and rel L2
   1e-5 against the fp32 twin, K2's and K5's saved row log-sum-exp within
   1e-5 of the twin's, each fp32 forward's time beside SDPA's backend): the
   gated K1 and K2
   at BEATs' shape (B=128, H=12, T=248, D=64), with and without the gate,
   without a mask, with a key-padding mask and with one item's keys all
   padded (NaN exactly where the twin has NaN); the bias-free K5 at EAT's
   shape (T=513) with and without a mask and at AVES's (T=249) with its frame
   mask, and K4 on the split views of EAT's projection. It times the kernel,
   the twin and one PyTorch library call (``scaled_dot_product_attention``, a
   yardstick the port never calls), and prints each kernel's TFLOP/s and
   share of its bound;
4. int8 kernels: K7 (``int8_dynamic_dense``) against its twin at BEATs'
   three (K, N) pairs, at M = 31,744 (B=128) and 248 (one clip), with x in
   bf16 and fp32, with and without the bias (fp32 and bf16 within 1 ulp,
   target 0), and each of its two kernels (the row quantization, the scaled
   wgmma product) exactly equal to its own twin; K8 (``int8_matmul``) exactly
   equal to its twin at ``scripts/bench_int8_matmul.py``'s shape. Times the
   kernel (K7: and each of its two kernels), the twin and a yardstick (bf16
   ``F.linear``, what the float model runs, for K7; ``torch._int_mm`` for
   K8);
5. BEATs main path: full-width BEATs (12 layers, 768-d) through
   ``load_model`` with seeded random weights and ``use_pallas=True``,
   ``extract_embeddings`` over all 13 layers with mean pooling on batches of
   5 s clips, in bf16 and fp32, then with ``fused_qkv=True``;
6. int8 BEATs main path: the same model through
   ``load_model(quantization="int8")`` in bf16 (K7 72 and K1 12 launches per
   forward), held to the float model with the same weights; every int8 layer
   held to the K7 twin on its own input inside the model (bf16 B=128 and fp32
   B=2); the fp32 int8 model against the same model on the CPU;
7. EAT main path: the official ``esp_aves2_sl_eat_all_ssl_all`` entry
   (12 blocks, 768-d, T=513 tokens) on 10 s clips, ``use_pallas=True`` in
   bf16 and fp32, and the plain path;
8. AVES main path: ``aves_bio`` (12 layers, 768-d, T=249 frames) on 5 s clips
   with a padding mask on a third of them, the same runs;
9. serving: the int8 and the float bf16 BEATs in one ``ServicePool`` behind
   ``AvexHTTPServer`` on an ephemeral port (buckets up to 32, warm-up of 1
   and 32); 8 producer threads submit 96 clips to each model (3 s, 7 s and
   8 kHz ones among them) and two requests go over HTTP (.npy, WAV). Every
   row is held to its clip extracted alone; prints requests/s and p50/p99
   latency per model;
10. backward kernels: K3 (the gated backward) against its backward twins at
   BEATs' training shape (B=64, T=248), in bf16 and fp32, with and without
   the gate and with a key-padding mask (bf16 also with one item's keys all
   padded, and at T=800, B=2): bf16 on the
   tensor cores from K2's residuals, held to the twin of that contract
   (dqkv, dbias and dgate) and to the twin that recomputes the softmax; K6
   (the bias-free backward) at EAT's (T=513, with and without a mask) and
   AVES's (T=249, frame mask). Times the
   kernel, the twin and a yardstick the port never calls (the backward of
   ``scaled_dot_product_attention``: forward+backward minus forward), and
   prints K6's TFLOP/s and, beside its device time, its time with the host's
   time to issue it through autograd. fp32 K3 and K6 run on the tensor cores
   in 3xTF32 (``tf32x3_attention.cu``, from the fp32 forward's saved
   log-sum-exp): each call's body checked, every output within rel L2 1e-5
   of the fp32 twin (TF32 off), and each timed beside the 3xTF32 bound;
11. BEATs training: full-width BEATs with a 50-class head, bf16 compute with
   fp32 parameters, ``fused_qkv=True, use_pallas=True``, dropout and
   LayerDrop as the official config gives them, through ``Trainer`` (AdamW,
   weight decay 0.01 with the mask, cosine schedule with warmup) on one
   seeded batch of 64 5 s clips: 1 untimed and 10 timed steps (K2 and K3 12
   launches per step, every other kernel 0; the loss falls); one step with
   gradient checkpointing (K2 24, K3 12); then the fp32 kernel path against
   the fp32 plain path, one step's loss and every gradient from the same
   weights, dropout and LayerDrop off (K3 on the 3xTF32 body), and each
   path's fp32 step timed (B=8, the median of 5);
12. EAT training: ``esp_aves2_sl_eat_all_ssl_all`` (T=513) with a 50-class
   head the same way (K5 and K6 12 launches per step; the fp32 steps timed);
13. AVES training: ``aves_bio`` (T=249, a third of the clips padded) the
   same way, with its dropout (0.1) and LayerDrop (0.05) on (K5 and the
   masked K6 12 launches per step); one generator seed gives one loss, two
   seeds two. For BEATs, EAT and AVES one bf16 step of the kernel path and
   one of the plain path are also held to the fp32 plain path's gradients:
   the kernel path (BEATs: the bf16 K2 with K3, both on the tensor cores;
   EAT and AVES: K5 with the bf16 K6) may be no farther from them than 1.25x
   the plain path;
14. probes and evaluation: a seeded labelled set of 512 clips in 10 classes
   (one band-limited tone a class, over noise) made on the card. EAT
   (``esp_aves2_sl_eat_all_ssl_all``, bf16, K5, 10 s clips): the last layer
   mean-pooled through the evaluation library's extraction loop (clips/s; K5
   12 launches a batch), kept in memory, then ``FineTuneTrainer`` offline
   with the ``linear`` and ``mlp`` presets (no kernel launched while the
   probe trains) and online with a frozen linear probe (K5 12 a forward, K6
   none; the backbone bit-identical after). BEATs (official
   config, bf16, 5 s clips): ``attention`` and ``transformer`` probes over
   layers 3, 7, 11 and the last (four [248, 768] sequences, learned layer
   weights), frozen (K1 12 a forward, no backward kernel); retrieval (same-set
   and cross-set) over the extraction loop's numpy output of the pooled last
   layer, the similarity product on the card by default and against a
   float64 CPU product (rel <= 1e-5); an unfrozen attention probe with
   ``fused_qkv=True`` (K2 and K3 12 a step, four steps on one batch at lr
   1e-5; the backbone changes; each epoch's loss within rel 5e-3 of the
   plain path's on the same weights); and
   the fp32 kernel path's probe logits against the plain path's (rel <=
   1e-3). Every training loss falls over its epochs; prints ms per step,
   clips/s and the retrieval time beside the card's name and power limit;
15. entry points: the data pipeline and the two entry points as a user runs
   them, from ``kind: local`` datasets of tone WAVs written here with the
   standard library's ``wave`` (8 classes; most clips 6 s at 16 kHz, one in
   8 at 44.1 kHz, one in 8 3 s long). ``run_train.main``: the official
   BEATs with ``fused_qkv=True, use_pallas=True``, bf16, 5 s crops, B=64,
   320 training and 64 validation clips, a noise and a mixup augmentation,
   4 loader worker processes, 2 epochs at lr 1e-5, a checkpoint each (K2 on
   every forward, K3 on every step, exactly; the loss falls; metrics.jsonl,
   the checkpoints and the label map written), then one more epoch through
   the same loader under the profiler (the device's busy share: the union
   of the kernels' intervals) and the loader's host work for one batch in
   one process, with its parts. ``run_evaluate.main``: the same BEATs frozen
   (K1 on every forward, no K2/K3) under an online attention probe over
   layers 3, 7, 11 and the last, on one evaluation set of 128/32/32 clips
   (the backbone built once; the probe's loss falls;
   evaluation_metadata.jsonl and the summary CSVs written). Prints steps/s,
   the step's wait for the loader and the busy share beside the card's name
   and power limit;
16. head width 80 (run after phase 10): K5 and K4 at Bird-MAE huge's
   forward shape (B=128, T=513, 16 heads of 80) and K6 at its training
   batch (B=64), bf16 on the tensor cores and fp32 on them in 3xTF32,
   against their twins (the bf16 K6 also against its residual twin), each timed beside
   its twin, its bound and SDPA (its backward for K6);
17. Bird-MAE main path (after phase 8): ``ModelSpec(name="birdmae",
   model_id="DBD-research-group/Bird-MAE-huge")`` through ``load_model``,
   1280 x 32, 10 s clips at 32 kHz (T=513), all 32 layers mean-pooled: bf16
   on K5 (32 launches a forward, every other kernel 0) and on the plain path
   at B=128, the fp32 kernel path against the fp32 plain path at B=8 (pooled
   and every tapped layer), then Bird-MAE base (dh 64, 12 a forward);
18. ATST main path (after phase 17): ``ModelSpec(name="atst")``, 12 x 768,
   10 s clips (T=250): the card's frontend against the CPU's (fp32, and the
   bf16 model's bf16-valued operands in TF32 against fp32 sums), the
   timestamp embedding's [B, 250, 9216] shape, then K5 (12 a forward) in
   bf16 and fp32 against the plain path, as the EAT phase;
19. Bird-MAE huge training (after phase 13): ``Trainer``, bf16, B=64, a
   50-class head, 5 timed steps (K5 and K6 32 launches each a step), one
   step under the profiler (the device's busy share), then the fp32 and
   bf16 gradient checks at B=8;
20. ATST training (after phase 19): ``Trainer``, bf16, B=64, 10 s clips, a
   50-class head, 10 timed steps (K5 and K6 12 launches each a step; the
   loss falls), then the fp32 and bf16 gradient checks at B=8;
21. the fp32 K3 past T=512 (after phase 10) on the 3xTF32 kernels: T=520
   and T=800, B=4, with the gate, with the gate and a padding mask, and
   with neither, dqkv, dbias and dgate against the twin (atol and rtol 1e-4,
   rel L2 1e-5); the same values on narrow rows (a row stride of 3E + 1
   floats) with the gate, with and without the mask: the 3xTF32 forward on
   narrow rows, the backward on the 3xTF32 kernels from its saved
   log-sum-exp, at the same bounds; timed at T=800 beside the twin, the fp32 SDPA backward
   and its bound;
22. an fp32 BEATs ``fused_qkv`` training step on 16 s clips (after phase
   11; T=792, B=4): the kernel path's loss and gradients against the plain
   path's, 12 K2 and 12 K3 launches (added to the main paths' counts);
23. EfficientNet-B0 (after phase 18) as the official
   ``esp_aves2_effnetb0_all`` entry builds it: 10 s clips (1001 frames of
   128 mels), B=128, all 17 taps mean-pooled through the 4-D aggregation,
   bf16 and fp32, the fp32 model on the card against the CPU (2 clips);
24. Perch (EfficientNet-B1, TF "SAME", BatchNorm eps 1e-3), 5 s at 32 kHz,
   B=128, bf16 and fp32: 10932 logits and the 1280-d embedding; then
   ResNet-152 at EfficientNet's audio config (chosen: the reference has
   none for ResNet), B=128, bf16 and fp32, its four taps, and ResNet-18
   and ResNet-50 for one batch each. No CNN launches a kernel of the port;
   their fp32 runs are under ``full_fp32()`` (no TF32 in cuDNN's convs);
25. (after phase 20) EfficientNet-B0 training through ``Trainer``: bf16,
   B=64, a 50-class head, 10 timed steps (the loss falls; every BatchNorm
   running statistic moves; the eval forward normalises with them), then
   fp32 gradients on the card against the CPU at B=4 (full fp32 convs,
   forward and backward). BirdNet has no phase: its TFLite graph runs on
   the host, and the card's machine has no TensorFlow;
26. (after phase 16) K5 and K6 at EAT-SSL's shapes, B=64, bf16 and fp32:
   the student's 103 visible tokens with 12 heads, the decoder's 512 with
   6 heads of 64 (384 wide), and K5 alone at the teacher's 512 with 12
   heads under no_grad; each against its twin, timed beside the twin, its
   bound and SDPA (its backward for K6; the fp32 K5 and K6 on 3xTF32);
27. (after phase 25) EAT-SSL pretraining at full width (768 x 12, decoder
   384 x 4, mask ratio 0.8, EMA teacher) through ``Trainer`` with
   ``label_type="self_supervised"``: bf16, B=64, 10 s clips, K5/K6 on every
   block (28 K5 and 16 K6 a step), 10 timed steps (the loss falls); the
   teacher after each of 3 more steps against decay·t + (1-decay)·s from
   snapshots; the plain path's ms a step; the fp32 kernel path's loss and
   gradients against the plain path's at B=4 with the same mask draw;
28. CLIP at full width (EfficientNet-B0 with ``esp_aves2_effnetb0_all``'s
   audio config, RoBERTa-base, projection 512; the offline tokenizer)
   through ``Trainer`` with ``label_type="text"``: bf16, B=64, 10 s tone
   clips of 10 classes with captions that name the class, 10 timed steps (the loss falls, every BatchNorm
   running statistic moves, a2t/t2a counted, no kernel of the port
   launched); audio-only extraction at B=128; fp32 gradients card vs CPU at
   B=4 (full fp32 convs, BatchNorm on its running statistics);
29. BEATs training with ``remat_policy="dots"`` (bf16, B=64, 5 s,
   ``fused_qkv``): ms a step and peak memory beside ``remat=False`` and
   ``remat_policy=None`` (K2 24 and K3 12 a step under either remat), and
   fp32 gradients with dropout and LayerDrop against ``remat=False``;
30. data parallelism (after phase 15) on spawned ranks that load the
   kernels phase 2 built, each rank group joined with a deadline and killed
   past it (a failed rank fails the phase, its traceback printed): (a)
   whether NCCL takes two ranks on one card (the answer printed; the
   two-rank runs then go over NCCL, or gloo if it refuses); (b) one rank
   over NCCL: full-width BEATs ``fused_qkv`` (K2/K3) cut to 4 layers
   (``DP_LAYERS``, for the script's time), bf16, B=64 5 s clips
   with dropout, one ``Trainer(mesh=...)`` step equal bit for bit to the
   step without a process group (deterministic algorithms in both); (c) two
   ranks sharing the card, 32 + 32 of the 64 clips: the fp32 step (dropout
   and LayerDrop off) held to the one-process step on all 64 (loss and
   every parameter rel 1e-3), then 5 timed bf16 steps with dropout on (ms a
   step, the gradient all-reduce's ms, each rank's peak memory and busy
   share: two ranks on one card measure the mechanism, not multi-card
   speed); (d) ZeRO-3 on the same ranks, the fp32 step held the same way,
   each rank's parameter and moment bytes, peak memory and (d)'s own wall
   seconds; (e) full-width
   EAT-SSL (K5/K6) and CLIP (global-batch BatchNorm, the features
   gathered), fp32, 8 + 8 against the one-process step on 16 (EAT-SSL's mask
   draw split across the ranks; stochastic depth keeps every item). The
   ranks send back their launch counts; K2, K3, K5 and K6 add them.
31-32. the model axis on gloo ranks sharing the card (``phase_model_parallel``,
   ``phase_model_axis_rest``: TP, GPipe, SP, ring attention, the MoE probe,
   the 3-D cell), BEATs, the pipelined EAT and Bird-MAE base and the EAT and
   Bird-MAE rings cut to ``DP_LAYERS`` as phase 30's BEATs;
33. the command line (``avex_tpu_torch.commands``, no click, h5py or PyYAML;
   BEATs cut to ``DP_LAYERS``):
   (a) ``embed``'s batches (``commands.embed_batches``, WAVs written with
   ``wave``: 64 of 6 s at 16 kHz and 8 at 44.1 kHz) into the extraction loop
   over the official BEATs on K1 (4 a batch), each row against
   ``model.extract_embeddings`` on the same centre crops; (b) ``--windowed``
   over four 120 s recordings, BEATs ``fused_qkv`` on 30 s windows (hop 15 s,
   K2 at T=1496) and EAT on 10 s windows (K5 at T=513), the manifest's
   offsets against ``window_waveform``'s, the ring off at one rank; (c)
   ``export`` of the official BEATs (plain attention) to a ``.pt2`` program
   with a dynamic batch, loaded on the card and held at B=4 and 16 to the
   eager model, its sidecar, and a ``use_pallas=True`` model refused; (d)
   ``serve`` in a child process (int8 BEATs, port 0), 32 clips from 8
   threads held to the same int8 model here, then SIGINT: exit code 0, the
   port free (the child's launches are not counted); (e) ``run_train`` with
   ``data_pipeline="grain"`` (the checkpointable loader, 4 workers, B=8 on
   40 clips: 5 steps an epoch, 2 epochs): an uninterrupted run, a run
   stopped mid-epoch by the preemption flag and the run resumed from its
   step checkpoint, whose batches equal the uninterrupted run's bit for bit
   and whose losses are within rel 1e-3 (K2 and K3 4 a step);
34. head widths other than 64 and 80 (the kernels take every multiple of 8
   up to 128): (kernels, after phase 26) K1-K6 at dh 16, 32, 96 and 128
   with E = 768 (48, 24, 8 and 6 heads), bf16 and fp32, at the shapes of
   phases 3 and 10 (K4/K5 B=128 T=513; K1/K2 B=128 T=248 with the gate; K3
   B=64 T=248; K6 B=64 T=513), each against its twin (the bf16 K3/K6 also
   against the twin of their contract; fp32 K1-K6, on 3xTF32, within rel
   L2 1e-5, K2's and K5's saved log-sum-exp within 1e-5) and timed beside
   the twin, its bound and SDPA (the fp32 ones also beside SDPA's
   backend), one ragged
   masked case a width (B=8, T=37, an item all padded in the forwards), and
   dh 20 and 136 against their twins; (paths, after phase 33) BEATs at full width and depth with 6
   heads of 128: bf16 extraction on K1 (12 a forward), the int8 model (K1
   with K7) against it, the fp32 kernel path against the plain path, a
   ``fused_qkv`` training step (K2 and K3 12 a step) and the fp32 gradient
   check; EAT with 24 heads of 32 the same way on K5/K6; and
   ``configs/run_configs/beats_supervised_example.yml`` (4 heads of 16)
   through ``run_train`` with ``use_pallas`` and ``fused_qkv`` set in the
   call (K2 on every forward, K3 on every step; every loss finite);
35. head widths that are not a multiple of 8 or are above 128 (narrow rows;
   column chunks): (kernels, after phase 34's) K1-K6 at dh 4, 12, 20, 33, 70,
   100, 136, 150, 192, 256, 320 and 512 with E = 768 or the nearest multiple
   of dh, bf16 and fp32, at phase 34's shapes (the batch cut where the
   twin's [B, H, T, T] logits would pass 9 GiB; B=16 at the widths not
   timed; every fp32 forward and backward on the 3xTF32 kernels (narrow
   rows, column chunks past 128), each call's body checked, K2's and K5's
   saved log-sum-exp within 1e-5 of the twin's, every fp32 call within rel
   L2 1e-5), each against its twin, one
   ragged masked case a width with an item all padded (NaN as the twin), and
   dh 12, 20, 136, 192, 256 and 320 timed beside the twin, the bound and SDPA
   (its backend printed; the median of 10 calls; the fp32 K1-K6 also beside
   the 3xTF32 bound and the FMA body's time, quoted from PERF.md), and K5 at dh 64 on 16-byte
   rows against the same values 2 bytes off (the general kernel); (paths, after phase 34's) BEATs at full width and
   depth with 4 heads of 192 (K1 extraction, int8 K1 + K7, the fp32 kernel
   path against the plain path, a ``fused_qkv`` training step on K2/K3 and
   the fp32 gradient check), EAT with 64 heads of 12 (K5 extraction, K5/K6
   training, the same checks) and Bird-MAE huge with 5 heads of 256 (K5
   extraction of 10 s clips at 32 kHz, the fp32 kernel path against the
   plain path, pooled and every tapped layer).

Every kernel, twin and yardstick time is the device's: the median of 20
calls, each between two CUDA events queued behind a sleep kernel, so the
host's time to issue the call is not in it.

Each main path checks shapes, finiteness, the kernel launch counts per
forward or step (every kernel of the port: those the path runs, and 0 for
the rest), the fp32 kernel path against the fp32 plain path, and prints
clips/s; the BEATs, EAT and AVES phases print both paths' bf16-vs-fp32
distance.

It then prints one JSON line of per-kernel numbers (``launches`` counts the
main paths' runs; K4 and K8, which no main path reaches, add
``kernel_phase_launches``; K4, K5 and K6 add ``head_dim_80``, their bf16 and
fp32 numbers at Bird-MAE huge's shapes; K3 adds ``fp32_past_512``, its fp32
numbers at T=800; K5 and K6 add ``eat_ssl``, their numbers at EAT-SSL's
shapes, and ``eat_ssl_launches``, the EAT-SSL run's share of ``launches``;
K1, K2, K4 and K5 add ``fp32_source``, ``fp32`` (their fp32 numbers at
the main shape on 3xTF32, with SDPA's backend) and
``fp32_tf32x3_launches``, the main paths' fp32 runs' launches on the
3xTF32 forward;
K2, K3, K5 and K6 add ``data_parallel_launches``, phase 30's share; K1, K2,
K3 and K5 add ``cli_launches``, phase 33's share; K1-K6 add
``head_widths``, their bf16 and fp32 numbers at dh 16, 32, 96 and 128, and
``head_width_kernel_phase_launches``; K1, K2, K3, K5, K6 and K7 add
``head_width_launches``, phase 34's paths' share of ``launches``; K1-K6 add
``wide_head_widths``, their numbers at dh 12, 20, 136, 192, 256 and 320, and
``wide_head_kernel_phase_launches``; K1, K2, K3, K5, K6 and K7 add
``wide_head_launches``, phase 35's paths' share; K3 and K6 add
``fp32_source``, ``fp32`` (their fp32 numbers at the main shape on the
3xTF32 kernels) and ``fp32_tf32x3_launches``, the main paths' fp32
gradient checks' launches on the 3xTF32 kernels) and,
last, the device line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before that
line. Nothing of JAX or of the JAX package is imported.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

B, H, T, D = 128, 12, 248, 64  # BEATs: 5 s at 16 kHz → 31 x 8 patches; 768 / 12 heads
E = H * D
T_EAT = 513  # EAT: 10 s → 1024 frames → 8 x 64 patches, plus the CLS token
T_AVES = 249  # AVES: 5 s at 16 kHz, 320-sample hop
CLIP_SAMPLES = 5 * 16000
EAT_CLIP_SAMPLES = 10 * 16000
AVES_PAD_FROM = 3 * 16000  # a third of the AVES clips are padded from 3 s (frame 150)
N_BATCHES = 4
N_BATCHES_EAT_AVES = 3
TIMED_LAUNCHES = 20
# A sleep kernel ahead of each timed call (~2-3 ms at the card's clocks) keeps
# the device busy while the host issues the call, so that the two CUDA events
# bracket the device's work alone: a wrapper's Python (autograd, operand
# checks) would otherwise be timed wherever it outlasts the kernel.
SLEEP_CYCLES = 4_000_000
# Device peaks of an H100 SXM (NVIDIA data sheet): HBM bytes/s, dense bf16
# tensor-core FLOP/s, fp32 FLOP/s outside the tensor cores, dense int8 OP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_INT8_OPS = 1979e12
# Int8 BEATs: the encoder's dense layers as (K, N), and launches per layer.
ENCODER_LAYERS = 12
INT8_SHAPES = {"q/k/v/out_proj": (E, E), "fc1": (E, 4 * E), "fc2": (4 * E, E)}
INT8_PER_LAYER = {"q/k/v/out_proj": 4, "fc1": 1, "fc2": 1}
INT8_PER_FORWARD = ENCODER_LAYERS * sum(INT8_PER_LAYER.values())  # 72
M_FULL, M_ONE = B * T, T  # rows of a B=128 batch and of one clip (serving bucket 1)
# K7 vs twin: the same int8 activations and int32 sums, rounded at the same
# steps; the target is 0 and the limit 1 unit in the last place (fp32 and bf16).
K7_MAX_ULPS = 1
INT8_FLOAT_REL = 5e-2  # int8 vs float pooled: the JAX package's test bound (test_quant.py:137)
# fp32 int8 on the card vs the same model on the CPU. Every int8 layer is
# held to its twin on its own inputs from the model first (max|d| 0). End to
# end, the float parts sum in another order on the CPU, and an activation
# that lands that close to a rounding boundary takes the neighbouring int8
# level on one side only; 12 random-weight layers carry those flips to ~2e-3
# of the pooled features. The phase prints the flips and the float model's
# own card-vs-CPU gap. 5e-3 stays well below the int8-vs-float gap.
INT8_CARD_CPU_REL = 5e-3
# Serving: 8 producer threads, 96 clips for each model; a served row against
# the clip alone, bf16 (cuBLAS may pick another algorithm for another M).
N_PRODUCERS, N_SERVED = 8, 96
SERVE_REL = 1e-2
SERVE_TIMEOUT = 300
# Kernel vs twin: fp32 max|Δ| — the online softmax adds the same terms in
# another order; bf16 relative L2 — the kernel rounds the unnormalised P to
# bf16 (the twin rounds the normalised one) and the output is rounded to bf16.
FP32_ATOL = 1e-4
BF16_REL_L2 = 5e-3
# Main path, fp32: the kernel path against the plain-attention path over 12
# layers with the same weights; sums in another order, compounded by depth.
# Training: the loss and each parameter's gradient, the same bound.
PATH_REL = 1e-3
# Backward kernels vs their twins: dqkv as the forward (fp32 max|d|, bf16
# relative L2); dbias sums 64 items and dgate 248 keys in another order than
# the twin, so both are held by relative L2 in fp32 too.
FP32_SUM_REL = 1e-5
# The fp32 K3 and K6 on the tensor cores in 3xTF32 (tf32x3_attention.cu: 16-byte
# rows, head widths a multiple of 8 up to 128) against the plain fp32 twin, TF32
# off: relative L2 of each of dqkv, dbias and dgate. One TF32 pass (hi·hi alone)
# lands near 5e-4 (tests/test_torch_tf32x3.py) and fails it.
TF32X3_REL_L2 = 1e-5
# 3xTF32 takes three TF32 products a product: the tensor cores' 495 TFLOP/s over 3.
TF32X3_FLOPS = 495e12 / 3
# The fp32 forward on 3xTF32 (K1, K2, K4, K5 on tf32x3_attention.cu): its row
# log-sum-exp, saved for the backward, against the twin's (natural units).
LSE_ATOL = 1e-5
T_LONG = 800  # a gated backward long past 512 (the bf16 K3 at B=2; the fp32 K3 at B=4)
# The fp32 K3 keeps its [64, T] dbias rows in shared memory up to T=512 and
# adds them in device memory past it (phases 21-22).
T_K3_FP32 = 520
B_LONG = 4
K3_LONG_TOL = 1e-4  # dqkv, dbias and dgate against the twin: atol and rtol
LONG_CLIP_SAMPLES = 16 * 16000  # BEATs on 16 s clips: T=792
# Training: B=64 clips (5 s for BEATs, 10 s for EAT), 1 untimed step, then
# timed steps on the same batch; a 50-class head.
B_TRAIN = 64
TRAIN_STEPS = 10
N_CLASSES = 50
B_GRAD_CHECK = 8  # the fp32 kernel-vs-plain gradient check (the plain path holds [B, H, T, T])
FP32_TIMED_STEPS = 5  # BEATs' and EAT's fp32 steps timed on each path (the median)
TPU_BF16_FP32_REL = 3.8e-3  # JAX package on a TPU v5e (BENCH_r05.json): a reference point only
# bf16 training: the kernel path's gradients (the bf16 K3 or K6 on the tensor cores)
# against the fp32 plain path's may be at most this factor farther than the
# bf16 plain path's: both round the same activations to bf16.
BF16_GRAD_FACTOR = 1.25

# Probes (phase 14): a synthetic labelled set, one band-limited tone a class.
PROBE_CLIPS, PROBE_CLASSES, B_PROBE = 512, 10, 64
PROBE_EPOCHS = 3  # online probes
UNFROZEN_EPOCHS = 4  # the unfrozen probe: one step an epoch, on one batch
UNFROZEN_LR = 1e-5  # a fine-tuning rate: at 1e-4 Adam's first steps overshoot on either attention path
UNFROZEN_LOSS_REL = 5e-3  # bf16: each epoch's loss, kernel path (K2/K3) against the plain path, same weights
OFFLINE_EPOCHS = 30  # offline probes: a step is a few ms
PROBE_LAYERS = [3, 7, 11, "last_layer"]  # BEATs: layers 2, 6, 10 and 11's outputs
B_PROBE_CHECK = 8  # the fp32 kernel-vs-plain probe logits (the plain path holds [B, H, T, T])
SIM_REL = 1e-5  # retrieval: the card's fp32 similarities against a float64 CPU product

# Entry points (phase 15): run_train and run_evaluate on ``kind: local`` tone
# WAVs written here, 8 classes; most clips 6 s at 16 kHz (a random 5 s crop),
# one in 8 at 44.1 kHz (resampled), one in 8 3 s (padded).
ENTRY_CLASSES, ENTRY_TRAIN, ENTRY_VAL = 8, 320, 64
# run_evaluate's evaluation set: train, val, test clips and the seed of the first (one set, for the script's time)
ENTRY_EVAL_SET, ENTRY_EVAL_SEED = (128, 32, 32), 43
ENTRY_EPOCHS, ENTRY_WORKERS = 2, 4
ENTRY_LR = 1e-5  # fine-tuning the random-weight BEATs: stable there (scripts/torch_probe_lr.py)
ENTRY_PROBE_LR = 1e-4  # the frozen attention probe: at 1e-3 its loss rose over two epochs on these clips
ENTRY_LONG_S, ENTRY_SHORT_S = 6.0, 3.0

# Bird-MAE (phases 16-18): huge is 1280 x 32 with 16 heads of 80 (dh 80 on
# K5/K6), base 768 x 12 (dh 64); 10 s at 32 kHz: 998 fbank frames padded to
# 1024, 64 x 8 patches plus the CLS token.
MAE_HUGE, MAE_BASE = "DBD-research-group/Bird-MAE-huge", "DBD-research-group/Bird-MAE-base"
MAE_CLIP_SAMPLES = 10 * 32000
T_MAE, H_MAE, D_MAE, MAE_LAYERS = 513, 16, 80, 32
E_MAE = H_MAE * D_MAE
N_BATCHES_MAE = 3
B_MAE_FP32 = 8  # the fp32 kernel-vs-plain check (the plain path holds [B, H, T, T] fp32)
B_TRAIN_MAE = 64
MAE_TRAIN_STEPS = 5
# ATST-Frame (phases 18 and 20): 12 x 768, 10 s at 16 kHz: 1001 frames, 250 tokens.
ATST_CLIP_SAMPLES = 10 * 16000
T_ATST = 250
# The frontend on the card vs the CPU: fp32 (DFT and mel products in full
# fp32), and bf16-valued DFT operands (TF32 on the card, fp32 on the CPU).
FRONTEND_CARD_CPU_REL = 1e-5
# The CNNs (phases 23-25): EfficientNet-B0 as the official entry builds it,
# 10 s at 16 kHz (1001 frames of 128 mels); Perch 5 s at 32 kHz; ResNet at
# EfficientNet's audio config. No kernel of the port: convs, BatchNorm and
# pooling are cuDNN's and PyTorch's, as JAX left them to XLA.
EFFNET_ENTRY = "esp_aves2_effnetb0_all"
EFFNET_CLIP_SAMPLES = 10 * 16000
EFFNET_FRAMES = 1001
PERCH_CLIP_SAMPLES = 5 * 32000
N_BATCHES_CNN = 3
# fp32 on the card (full fp32 convs, no TF32) vs the CPU: sums in another
# order over 17-25 conv layers with BatchNorm; features and a training step.
CNN_CARD_CPU_REL = 1e-3
B_CNN_GRAD = 4
# bf16 eval: one clip alone vs in a batch of 8 (cuDNN may pick other algorithms)
CNN_BATCH_REL = 1e-2
# EAT-SSL (phases 26-27): 10 s clips, 8 x 64 = 512 patches, 409 masked and 103
# seen by the student; the decoder is 384 wide with 6 heads of 64.
T_SSL, T_SSL_VISIBLE = 512, 103
H_SSL_DECODER, E_SSL_DECODER = 6, 384
SSL_PLAIN_STEPS = 3  # the plain path's ms a step beside the kernel path's
B_SSL_GRAD = 4  # the fp32 kernel-vs-plain gradient check
# CLIP (phase 28): from random towers the clips' embeddings start nearly equal
# (the loss near ln B); at 3e-4 Adam's first steps overshoot and the loss rises
# above ln B, at 1e-5 it falls (scripts/torch_clip_lr.py, on the CPU).
CLIP_LR = 1e-5
# BEATs remat "dots" (phase 29): timed steps of each of three remat settings.
DOTS_STEPS = 3

# Data parallelism (phase 30): timed steps a rank, BEATs' depth there (cut from
# 12 for the script's time: gloo stages every gradient through host memory),
# EAT-SSL's and CLIP's global batch, and the seconds a rank group (a
# collective) may take before it is killed.
DP_STEPS = 5
DP_LAYERS = 4
B_DP_SMALL = 16
DP_PROBE_TIMEOUT = 90
DP_TIMEOUT = 600
DP_COLLECTIVE_TIMEOUT = 300
ADAM_EPS = 1e-8  # AdamW's (optax's scale_by_adam)
# phase 31: the model axis on two ranks sharing the card
B_MP_CHECK = 8  # the fp32 steps held to one process (divides into the microbatches)
B_MP_TIMED = 16  # the timed bf16 TP steps, on each rank (the data axis has one rank)
B_MP_SMALL = 4  # (d): the 2 x 2 mesh's global batch
MP_MICROBATCHES = 4
MP_STEPS = 5
MP_TIMEOUT = 400
DP_LR = 3e-4  # BEATs' and EAT-SSL's; every phase-30 step at its full rate (no warmup)
# phase 33: the command line
CLI_CLIPS, CLI_RESAMPLED, CLI_BATCH = 64, 8, 32  # (a): 6 s clips at 16 kHz, then 44.1 kHz ones; embed's batch
CLI_LONG_N, CLI_LONG_S = 4, 120  # (b): recordings of 120 s at 16 kHz
CLI_WINDOW_BEATS, CLI_HOP_BEATS, CLI_WINDOW_EAT = 30.0, 15.0, 10.0  # BEATs T=1496, EAT T=513
CLI_ROW_REL = 1e-6  # an embed row against model.extract_embeddings on the same clip (bit-equal expected)
CLI_EXPORT_REL = {"float32": 1e-5, "bfloat16": 1e-3}  # the loaded program against the eager model, pooled
CLI_SERVED, CLI_SERVE_THREADS = 32, 8
CLI_SERVE_START, CLI_SIGINT_EXIT = 300, 30  # s for the serve child to print its URL; to exit after SIGINT
GRAIN_STEPS, GRAIN_EPOCHS, GRAIN_STOP = 5, 2, 7  # (e): steps an epoch, epochs, the step the stopped run ends on
# (e)'s batch and clips: 5 steps an epoch (cut from B=64 on phase 15's 320 clips, then from B=16 on 80, for
# the script's time: the loader's resampling, not the model, sets its pace)
B_GRAIN, GRAIN_CLIPS = 8, 40
GRAIN_CHECKPOINT_EVERY = 2
GRAIN_LOSS_REL = 1e-3  # a resumed step's loss against the uninterrupted run's (bf16, cuDNN's backward)

FAILURES: list = []
CARD: list = []  # nvidia-smi's name and power limit
# The fp32 gradient checks' backward launches on the 3xTF32 kernels, by kernel
# (``step_gradients``): the main paths' fp32 steps run K3 and K6 there.
TF32X3_STEP_LAUNCHES = {"fused_qkv_gated_attention_backward": 0, "fused_qkv_attention_backward": 0}
# The main paths' fp32 forward launches on the 3xTF32 kernels, by kernel (``drive``'s
# fp32 extraction runs and ``step_gradients``' fp32 kernel-path steps).
TF32X3_FORWARD_LAUNCHES = {"gated_bias_attention": 0, "fused_qkv_gated_attention": 0, "plain_attention": 0,
                           "fused_qkv_attention": 0}
PHASE_SECONDS: dict = {}  # phase function → wall seconds


def check(ok: bool, what: str) -> None:
    print(("ok    " if ok else "FAIL  ") + what)
    if not ok:
        FAILURES.append(what)


def timed(phase, *args):
    """Run one phase; its wall seconds go to PHASE_SECONDS under its name."""
    start = time.perf_counter()
    result = phase(*args)
    PHASE_SECONDS[phase.__name__] = round(time.perf_counter() - start, 1)
    print(f"{phase.__name__}: {PHASE_SECONDS[phase.__name__]} s")
    return result


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def median_ms(fn, n: int = TIMED_LAUNCHES, device_only: bool = True) -> float:
    """Median of ``n`` launches, each between two CUDA events, after two
    warm-ups. ``device_only``: each call queued behind a sleep kernel, so the
    host's time to issue it is not timed."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def attention_bound_ms(dtype_name: str, gated: bool, padded: bool, seq: int = T, heads: int = H,
                       dim: int = D, bsz: int = B, tf32x3: bool = False) -> tuple:
    """Least time for one attention call at (bsz, heads, seq, dim) on the card:
    q, k, v read and out written once, the fp32 bias (gated) and gate read
    once, the mask read once; two matmuls of 2·seq·seq·dim FLOPs per (batch,
    head), at the type's peak or, with ``tf32x3`` (fp32 on the tensor cores),
    at TF32X3_FLOPS."""
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = 4 * bsz * heads * seq * dim * elem
    nbytes += heads * seq * seq * 4 + bsz * heads * seq * 4 if gated else 0
    nbytes += bsz * seq if padded else 0
    flops = 4.0 * bsz * heads * seq * seq * dim
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (TF32X3_FLOPS if tf32x3 else PEAK_FLOPS[dtype_name]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tflops(flops: float, ms: float) -> float:
    return flops / ms / 1e9


def phase_card():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the port's smoke run needs one", file=sys.stderr)
        sys.exit(2)
    import avex_tpu_torch  # noqa: F401  (fails here, before any output, outside a checkout)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    CARD.append(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")


def phase_build():
    """Every CUDA source of the port, the attention sources once for each
    head width they are built for, one nvcc each, all at once; prints each
    build's nvcc seconds and, per kernel, its registers and spills."""
    from avex_tpu_torch.ops import _build
    from avex_tpu_torch.ops import attention_kernels as ak

    sources = sorted(p.name for p in _build.CSRC_DIR.glob("*.cu"))
    jobs = [(name, width) for name in sources
            for width in (ak.KERNEL_WIDTHS if name in (ak.TENSOR_CORE_SOURCE, ak.TF32X3_SOURCE)
                          else (None,))]
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: _build.build(*job), jobs))
    print(f"build: {len(jobs)} builds of {len(sources)} source(s) in {time.perf_counter() - start:.2f} s: {sources}, "
          f"the attention sources at head widths {ak.KERNEL_WIDTHS}")
    spills = 0
    for name, (seconds, log) in sorted(_build.BUILD_LOG.items()):
        print(f"  {name}: nvcc {seconds:.2f} s")
        kernel = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"    {kernel}: {line.split(':', 1)[-1].strip()}")
                if "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line:
                    spills += 1
    cached = [_build.build_name(*job) for job in jobs if _build.build_name(*job) not in _build.BUILD_LOG]
    if cached:
        print(f"build: {len(cached)} of {len(jobs)} builds were already in build/ and not compiled here, "
              f"so their spills are not checked: {cached}")
    check(spills == 0, f"build: {spills} kernel(s) spill registers in the {len(jobs) - len(cached)} builds "
                       f"compiled here (0 bytes in every build)")


def phase_kernels():
    """Each kernel against its twin; returns per-kernel numbers for the JSON line."""
    import torch
    import torch.nn.functional as F

    from avex_tpu_torch.ops import attention_kernels as ak

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        # As the main path hands them over: split q/k/v are [B, H, T, D] views
        # of three [B, T, E] projections; the fused kernel reads [B, T, 3E].
        qkv = torch.randn(B, T, 3 * E, device="cuda", generator=gen).to(dtype)
        q, k, v = (
            torch.randn(B, T, E, device="cuda", generator=gen).to(dtype).view(B, T, H, D).permute(0, 2, 1, 3)
            for _ in range(3)
        )
        bias = torch.randn(H, T, T, device="cuda", generator=gen)
        gate = torch.rand(B, H, T, device="cuda", generator=gen) + 1.0  # BEATs gates lie in (1, 3)
        mask = torch.zeros(B, T, dtype=torch.bool, device="cuda")
        mask[1::3, 200:] = True
        mask[2::7, 17:] = True
        padded_item = mask.clone()
        padded_item[0] = True  # every key of item 0 padded: NaN there, as the twin's softmax gives
        qs, ks, vs = (t.permute(0, 2, 1, 3) for t in qkv.view(B, T, 3, H, D).unbind(2))

        with torch.no_grad():
            for kname, run, twin in (
                (
                    "gated_bias_attention",
                    lambda g, m: ak.gated_bias_attention(q, k, v, bias, g, m),
                    lambda g, m: ak.gated_bias_attention_reference(q, k, v, bias, g, m),
                ),
                (
                    "fused_qkv_gated_attention",
                    lambda g, m: ak.fused_qkv_gated_attention(qkv, H, bias, g, m),
                    lambda g, m: ak.fused_qkv_gated_reference(qkv, H, bias, g, m),
                ),
            ):
                worst = 0.0
                fp32 = dtype == torch.float32
                for g in (gate, None):
                    for mask_name, m in (("none", None), ("mask", mask), ("padded item", padded_item)):
                        got, bodies = bodies_of(lambda: run(g, m), forward=True)
                        want = twin(g, m)
                        torch.cuda.synchronize()
                        label = f"{kname} {name} gate={g is not None} mask={mask_name}"
                        want_body = "tf32x3" if fp32 else "bf16"
                        check(bodies == {want_body: 1}, f"{label}: ran on the {want_body} body ({bodies})")
                        if fp32:
                            worst = max(worst, fp32_forward_held(label, got, want))
                            continue
                        nan = torch.isnan(want)
                        check(torch.equal(torch.isnan(got), nan) and bool(torch.isfinite(got[~nan]).all()),
                              f"{label}: NaN exactly where the twin has NaN ({int(nan.any(dim=-1).sum())} rows), "
                              f"finite elsewhere")
                        got, want = got[~nan], want[~nan]
                        err = float((got.float() - want.float()).abs().max())
                        rel = rel_l2(got, want)
                        worst = max(worst, err)
                        check(rel <= BF16_REL_L2, f"{label}: rel L2={rel:.3e} <= {BF16_REL_L2:g} (max|d| {err:.3e})")
                if fp32 and kname == "fused_qkv_gated_attention":
                    for m in (None, padded_item):
                        lse_held(f"{kname} {name} mask={m is not None}", qkv, H, m, bias, gate)

                ms = median_ms(lambda: run(gate, None))
                plain_ms = median_ms(lambda: twin(gate, None))
                sdpa_q, sdpa_k, sdpa_v = (q, k, v) if kname == "gated_bias_attention" else (qs, ks, vs)
                attn_mask = (gate[..., None] * bias[None]).to(dtype)  # materialised outside the timing
                library_ms = median_ms(
                    lambda: F.scaled_dot_product_attention(sdpa_q, sdpa_k, sdpa_v, attn_mask=attn_mask, scale=D**-0.5)
                )
                bound, bound_by = attention_bound_ms(name, gated=True, padded=False, tf32x3=fp32)
                body = "tensor cores, 3xTF32" if fp32 else "tensor cores"
                fp32_numbers, note = fp32_forward_timing(sdpa_q, sdpa_k, sdpa_v, attn_mask) if fp32 else ({}, "")
                print(
                    f"time {kname} {name} (gate, no mask, {body}): kernel {ms:.4f} ms "
                    f"({tflops(4.0 * B * H * T * T * D, ms):.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
                    f"sdpa {library_ms:.4f} ms, bound {bound:.4f} ms by {bound_by} ({bound / ms:.1%} of bound)"
                    f"{note}; {CARD[0]}"
                )
                results[(kname, name)] = dict(
                    max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=bound, bound_by=bound_by, **fp32_numbers,
                )
        del qkv, q, k, v, qs, ks, vs, bias, gate, mask, padded_item
        torch.cuda.empty_cache()
    return results


def phase_bias_free_kernels():
    """K5 and K4 against their twins at EAT's and AVES's shapes; returns
    per-kernel numbers for the JSON line and K4's launches (no model reaches
    K4 at full width: the kernel phase is where it runs)."""
    import torch
    import torch.nn.functional as F

    from avex_tpu_torch.ops import attention_kernels as ak

    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {}
    ak.reset_launch_counts()
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        qkv = torch.randn(B, T_EAT, 3 * E, device="cuda", generator=gen).to(dtype)
        # _Block's split branch: [B, H, T, D] views of the one projection
        q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(B, T_EAT, 3, H, D).unbind(2))
        eat_mask = torch.zeros(B, T_EAT, dtype=torch.bool, device="cuda")
        eat_mask[1::3, 300:] = True
        eat_mask[2::7, 17:] = True
        aves_qkv = torch.randn(B, T_AVES, 3 * E, device="cuda", generator=gen).to(dtype)
        aves_q, aves_k, aves_v = (t.permute(0, 2, 1, 3) for t in aves_qkv.view(B, T_AVES, 3, H, D).unbind(2))
        aves_mask = torch.zeros(B, T_AVES, dtype=torch.bool, device="cuda")
        aves_mask[::3, 150:] = True
        cases = (
            # (kernel, shape label, seq, kernel call, twin, masks checked, mask timed, SDPA views)
            ("fused_qkv_attention", "EAT", T_EAT,
             lambda m: ak.fused_qkv_attention(qkv, H, m), lambda m: ak.fused_qkv_reference(qkv, H, m),
             (None, eat_mask), None, (q, k, v)),
            ("plain_attention", "EAT", T_EAT,
             lambda m: ak.gated_bias_attention(q, k, v, None, None, m),
             lambda m: ak.gated_bias_attention_reference(q, k, v, None, None, m),
             (None, eat_mask), None, (q, k, v)),
            ("fused_qkv_attention", "AVES", T_AVES,
             lambda m: ak.fused_qkv_attention(aves_qkv, H, m), lambda m: ak.fused_qkv_reference(aves_qkv, H, m),
             (aves_mask,), aves_mask, (aves_q, aves_k, aves_v)),
        )
        fp32 = dtype == torch.float32
        with torch.no_grad():
            for kname, shape, seq, run, twin, masks, timed_mask, views in cases:
                worst = 0.0
                for m in masks:
                    got, bodies = bodies_of(lambda: run(m), forward=True)
                    want = twin(m)
                    torch.cuda.synchronize()
                    label = f"{kname} {shape} T={seq} {name} mask={m is not None}"
                    want_body = "tf32x3" if fp32 else "bf16"
                    check(bodies == {want_body: 1}, f"{label}: ran on the {want_body} body ({bodies})")
                    if fp32:
                        worst = max(worst, fp32_forward_held(label, got, want))
                        continue
                    err = float((got.float() - want.float()).abs().max())
                    rel = rel_l2(got, want)
                    worst = max(worst, err)
                    check(bool(torch.isfinite(got).all()), f"{label}: finite")
                    check(rel <= BF16_REL_L2, f"{label}: rel L2={rel:.3e} <= {BF16_REL_L2:g} (max|d| {err:.3e})")
                if fp32 and kname == "fused_qkv_attention":
                    fused = qkv if shape == "EAT" else aves_qkv
                    for m in masks:
                        lse_held(f"{kname} {shape} T={seq} {name} mask={m is not None}", fused, H, m)

                ms = median_ms(lambda: run(timed_mask))
                plain_ms = median_ms(lambda: twin(timed_mask))
                keep = None if timed_mask is None else ~timed_mask[:, None, None, :]  # SDPA: True = attend
                library_ms = median_ms(lambda: F.scaled_dot_product_attention(*views, attn_mask=keep, scale=D**-0.5))
                bound, bound_by = attention_bound_ms(name, gated=False, padded=timed_mask is not None, seq=seq,
                                                     tf32x3=fp32)
                body = "tensor cores, 3xTF32" if fp32 else "tensor cores"
                fp32_numbers, note = fp32_forward_timing(*views, keep) if fp32 else ({}, "")
                print(
                    f"time {kname} {shape} T={seq} {name} (mask={timed_mask is not None}, {body}): kernel {ms:.4f} ms "
                    f"({tflops(4.0 * B * H * seq * seq * D, ms):.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
                    f"sdpa {library_ms:.4f} ms, bound {bound:.4f} ms by {bound_by} ({bound / ms:.1%} of bound)"
                    f"{note}; {CARD[0]}"
                )
                results[(kname, shape, name)] = dict(
                    max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=bound, bound_by=bound_by, **fp32_numbers,
                )
        del qkv, q, k, v, aves_qkv, aves_q, aves_k, aves_v, eat_mask, aves_mask
        torch.cuda.empty_cache()
    k4_launches = ak.LAUNCHES["plain_attention"]
    print(f"plain_attention (K4) launched {k4_launches} times in this phase")
    return results, k4_launches


def backward_bound_ms(dtype_name: str, bsz: int, seq: int, gated: bool, padded: bool, heads: int = H,
                      dim: int = D, tf32x3: bool = False) -> tuple:
    """Least time for one attention backward at (bsz, heads, seq, dim): q, k,
    v and dO read and dq, dk, dv written once; the fp32 bias and gate read
    and dbias and dgate written once (gated); the mask read once; five
    products of 2·seq·seq·dim FLOPs per (item, head), at the type's peak or,
    with ``tf32x3`` (fp32 on the tensor cores), at TF32X3_FLOPS."""
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = 7 * bsz * heads * seq * dim * elem
    nbytes += 2 * (heads * seq * seq * 4 + bsz * heads * seq * 4) if gated else 0
    nbytes += bsz * seq if padded else 0
    flops = 10.0 * bsz * heads * seq * seq * dim
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (TF32X3_FLOPS if tf32x3 else PEAK_FLOPS[dtype_name]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bodies_of(run, forward: bool = False) -> tuple:
    """Run ``run`` (backward calls, or forward calls with ``forward``);
    returns its result and the calls it made by body
    (``attention_kernels.BACKWARD_BODIES`` or ``FORWARD_BODIES``)."""
    import torch

    from avex_tpu_torch.ops import attention_kernels as ak

    counts = ak.FORWARD_BODIES if forward else ak.BACKWARD_BODIES
    before = dict(counts)
    result = run()
    torch.cuda.synchronize()
    return result, {k: v - before[k] for k, v in counts.items() if v != before[k]}


def fp32_backward_note(ms: float, bsz: int, seq: int, heads: int = H, dim: int = D) -> str:
    """The tail of an fp32 backward's time line on the 3xTF32 kernels: the
    3xTF32 bound."""
    bound = backward_bound_ms("float32", bsz, seq, False, False, heads, dim, tf32x3=True)[0]
    return f"; 3xTF32 bound {bound:.4f} ms ({bound / ms:.1%} of it)"


def fp32_forward_held(label, got, want) -> float:
    """The fp32 forward on 3xTF32 against its twin (TF32 off): NaN exactly
    where the twin has NaN, finite elsewhere, max|d| <= FP32_ATOL and
    relative L2 <= TF32X3_REL_L2; returns max|d|."""
    import torch

    nan = torch.isnan(want)
    check(torch.equal(torch.isnan(got), nan) and bool(torch.isfinite(got[~nan]).all()),
          f"{label}: NaN exactly where the twin has NaN ({int(nan.any(dim=-1).sum())} rows), finite elsewhere")
    got, want = got[~nan].float(), want[~nan].float()
    err, rel = float((got - want).abs().max()), rel_l2(got, want)
    check(err <= FP32_ATOL and rel <= TF32X3_REL_L2,
          f"{label}: max|d|={err:.3e} <= {FP32_ATOL:g}, rel L2={rel:.3e} <= {TF32X3_REL_L2:g} (3xTF32)")
    return err


def lse_held(label, qkv, heads, mask=None, bias=None, gate=None) -> None:
    """K2 (with ``bias``) or K5 under grad, fp32 (on 3xTF32):
    the row log-sum-exp it saves for the backward against the twin's at
    LSE_ATOL, −inf exactly where the twin's is (a row whose keys are all
    padded)."""
    import torch

    from avex_tpu_torch.ops import attention_kernels as ak

    leaf = qkv.detach().requires_grad_()
    with torch.enable_grad():  # the callers run under no_grad
        out = (ak.fused_qkv_gated_attention(leaf, heads, bias, gate, mask) if bias is not None
               else ak.fused_qkv_attention(leaf, heads, mask))
    lse = out.grad_fn.saved_tensors[-1]
    with torch.no_grad():
        _, want, _ = ak._fused_qkv_forward_lse_reference(qkv.detach(), heads, mask, None, bias, gate)
    finite = torch.isfinite(want)
    err = float((lse[finite] - want[finite]).abs().max())
    check(lse.shape == want.shape and torch.equal(torch.isfinite(lse), finite) and err <= LSE_ATOL,
          f"{label}: the saved row log-sum-exp within {LSE_ATOL:g} of the twin's (max|d| {err:.3e}), -inf on "
          f"exactly its {int((~finite).sum())} padded rows")
    del out, lse, want


def fp32_forward_timing(q, k, v, attn_mask=None) -> tuple:
    """The fp32 forward's numbers beside its 3xTF32 time: SDPA's backend for
    these operands. Returns (a dict for the JSON line, the tail of the time
    line)."""
    backend = sdpa_backend(q, k, v, attn_mask)
    return dict(sdpa_backend=backend), f"; sdpa backend {backend}"


def phase_backward_kernels():
    """K3 and K6 against their backward twins at the training shapes; returns
    per-kernel numbers for the JSON line (bf16, the training runs' type)."""
    import torch

    from avex_tpu_torch.ops import attention_kernels as ak

    gen = torch.Generator(device="cuda").manual_seed(8)
    results = {}

    def check_grads(label, dtype, got, want):
        """NaN exactly where the twin has NaN; elsewhere finite and within
        the bound (fp32 max|d| and, on the 3xTF32 kernels, relative L2 for
        each output; bf16 relative L2)."""
        names = ("dqkv", "dbias", "dgate")
        worst = 0.0
        for name, g, w in zip(names, got, want):
            if w is None:
                check(g is None, f"{label}: no {name} without its input")
                continue
            nan = torch.isnan(w)
            check(g.shape == w.shape and g.dtype == w.dtype and torch.equal(torch.isnan(g), nan)
                  and bool(torch.isfinite(g[~nan]).all()),
                  f"{label}: {name} {tuple(g.shape)} {g.dtype}, NaN on exactly the twin's {int(nan.sum())}")
            if nan.all():
                continue
            g, w = g[~nan].float(), w[~nan].float()
            err = float((g - w).abs().max())
            rel = rel_l2(g, w)
            if name != "dqkv" and dtype == torch.float32:
                check(rel <= TF32X3_REL_L2, f"{label}: {name} rel L2={rel:.3e} <= {TF32X3_REL_L2:g} (max|d| {err:.3e})")
            elif dtype == torch.float32:
                check(err <= FP32_ATOL and rel <= TF32X3_REL_L2,
                      f"{label}: dqkv max|d|={err:.3e} <= {FP32_ATOL:g}, rel L2={rel:.3e} <= {TF32X3_REL_L2:g}")
            else:
                check(rel <= BF16_REL_L2, f"{label}: {name} rel L2={rel:.3e} <= {BF16_REL_L2:g} (max|d| {err:.3e})")
            worst = max(worst, err if name == "dqkv" else 0.0)
        return worst

    def gated_case(dtype, bsz, seq, g, m, qkv, bias, dout):
        """One gated backward: the kernel against its twins. bf16 (tensor
        cores, from K2's residuals): every output against the twin of its
        contract on those residuals, and against the twin that recomputes
        the softmax; fp32 (3xTF32): against the latter."""
        name = str(dtype).split(".")[1]
        inputs = (qkv, bias) if g is None else (qkv, bias, g)
        out = ak.fused_qkv_gated_attention(qkv, H, bias, g, m)
        *_, saved_out, rest, lse = out.grad_fn.saved_tensors  # K2's residuals (no rest in fp32)
        got, bodies = bodies_of(lambda: (*torch.autograd.grad(out, inputs, dout), None)[:3])
        gd = None if g is None else g.detach()
        plain = ak.fused_qkv_gated_backward_reference(qkv.detach(), H, bias.detach(), gd, m, dout)
        torch.cuda.synchronize()
        padded = "none" if m is None else ("an item all padded" if bool(m.all(dim=1).any()) else "some keys")
        label = f"fused_qkv_gated_attention_backward B={bsz} T={seq} {name} gate={g is not None} mask={padded}"
        want_body = "bf16" if dtype == torch.bfloat16 else "tf32x3"
        check(bodies == {want_body: 1}, f"{label}: ran on the {want_body} body ({bodies})")
        if dtype == torch.float32:
            return check_grads(label, dtype, got, plain)
        own = ak.fused_qkv_backward_from_residuals_reference(qkv.detach(), saved_out, lse, m, dout,
                                                             out_rest=rest, pos_bias=bias.detach(), gate=gd)
        worst = check_grads(label + " vs its residual twin", dtype, got, own)
        check_grads(label + " vs the softmax twin", dtype, got, plain)
        return worst

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        qkv = torch.randn(B_TRAIN, T, 3 * E, device="cuda", generator=gen).to(dtype).requires_grad_()
        bias = torch.randn(H, T, T, device="cuda", generator=gen).requires_grad_()
        gate = (torch.rand(B_TRAIN, H, T, device="cuda", generator=gen) + 1.0).requires_grad_()
        dout = torch.randn(B_TRAIN, T, E, device="cuda", generator=gen).to(dtype)
        mask = torch.zeros(B_TRAIN, T, dtype=torch.bool, device="cuda")
        mask[1::3, 200:] = True
        masks = (None, mask)
        if dtype == torch.bfloat16:
            all_padded = mask.clone()
            all_padded[0] = True
            masks = (None, mask, all_padded)
        worst = 0.0
        for g in (gate, None):
            for m in masks:
                worst = max(worst, gated_case(dtype, B_TRAIN, T, g, m, qkv, bias, dout))
        out = ak.fused_qkv_gated_attention(qkv, H, bias, gate)
        ms = median_ms(lambda: torch.autograd.grad(out, (qkv, bias, gate), dout, retain_graph=True))
        plain_ms = median_ms(lambda: ak.fused_qkv_gated_backward_reference(
            qkv.detach(), H, bias.detach(), gate.detach(), None, dout))
        q, k, v = (t.detach().permute(0, 2, 1, 3).requires_grad_()
                   for t in qkv.detach().view(B_TRAIN, T, 3, H, D).unbind(2))
        gated_bias = (gate.detach()[..., None] * bias.detach()[None]).to(dtype).requires_grad_()
        library_ms = sdpa_backward_ms(q, k, v, gated_bias, dout)
        fp32 = dtype == torch.float32
        bound, bound_by = backward_bound_ms(name, B_TRAIN, T, gated=True, padded=False, tf32x3=fp32)
        body = "tensor cores, 3xTF32" if fp32 else "tensor cores"
        note = fp32_backward_note(ms, B_TRAIN, T) if fp32 else ""
        print(f"time fused_qkv_gated_attention_backward B={B_TRAIN} T={T} {name} (gate, no mask, {body}): "
              f"kernel {ms:.4f} ms ({tflops(10.0 * B_TRAIN * H * T * T * D, ms):.1f} TFLOP/s), "
              f"plain {plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms, bound {bound:.4f} ms by {bound_by} "
              f"({bound / ms:.1%} of bound){note}; {CARD[0]}")
        results[("fused_qkv_gated_attention_backward", name)] = dict(
            max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound, bound_by=bound_by)
        del qkv, bias, gate, dout, mask, masks, out, q, k, v, gated_bias
        torch.cuda.empty_cache()
        if dtype == torch.bfloat16:
            # Long clips: the tensor-core K3 at T=800 (the fp32 one in phase 21).
            qkv = torch.randn(2, T_LONG, 3 * E, device="cuda", generator=gen).to(dtype).requires_grad_()
            bias = torch.randn(H, T_LONG, T_LONG, device="cuda", generator=gen).requires_grad_()
            gate = (torch.rand(2, H, T_LONG, device="cuda", generator=gen) + 1.0).requires_grad_()
            dout = torch.randn(2, T_LONG, E, device="cuda", generator=gen).to(dtype)
            gated_case(dtype, 2, T_LONG, gate, None, qkv, bias, dout)
            del qkv, bias, gate, dout

        for shape, seq in (("EAT", T_EAT), ("AVES", T_AVES)):
            qkv = torch.randn(B_TRAIN, seq, 3 * E, device="cuda", generator=gen).to(dtype).requires_grad_()
            dout = torch.randn(B_TRAIN, seq, E, device="cuda", generator=gen).to(dtype)
            mask = torch.zeros(B_TRAIN, seq, dtype=torch.bool, device="cuda")
            if shape == "AVES":
                mask[::3, 150:] = True
            else:
                mask[1::3, 300:] = True
                mask[2::7, 17:] = True
            worst = 0.0
            # EAT without a mask (the timed call) and with one; AVES with its frame mask
            for m in ((None, mask) if shape == "EAT" else (mask,)):
                out = ak.fused_qkv_attention(qkv, H, m)
                (got,), bodies = bodies_of(lambda: torch.autograd.grad(out, (qkv,), dout))
                want = ak.fused_qkv_backward_reference(qkv.detach(), H, m, dout)
                torch.cuda.synchronize()
                label = f"fused_qkv_attention_backward {shape} T={seq} {name} mask={m is not None}"
                want_body = "bf16" if dtype == torch.bfloat16 else "tf32x3"
                check(bodies == {want_body: 1}, f"{label}: ran on the {want_body} body ({bodies})")
                worst = max(worst, check_grads(label, dtype, (got,), (want,)))
            if shape == "EAT":
                mask = None
            out = ak.fused_qkv_attention(qkv, H, mask)
            ms = median_ms(lambda: torch.autograd.grad(out, (qkv,), dout, retain_graph=True))
            host_ms = median_ms(lambda: torch.autograd.grad(out, (qkv,), dout, retain_graph=True), device_only=False)
            plain_ms = median_ms(lambda: ak.fused_qkv_backward_reference(qkv.detach(), H, mask, dout))
            q, k, v = (t.detach().permute(0, 2, 1, 3).requires_grad_()
                       for t in qkv.detach().view(B_TRAIN, seq, 3, H, D).unbind(2))
            keep = None if mask is None else ~mask[:, None, None, :]  # SDPA: True = attend
            library_ms = sdpa_backward_ms(q, k, v, keep, dout)
            fp32 = dtype == torch.float32
            bound, bound_by = backward_bound_ms(name, B_TRAIN, seq, gated=False, padded=mask is not None, tf32x3=fp32)
            body = "tensor cores, 3xTF32" if fp32 else "tensor cores"
            note = fp32_backward_note(ms, B_TRAIN, seq) if fp32 else ""
            print(f"time fused_qkv_attention_backward {shape} B={B_TRAIN} T={seq} {name} (mask={mask is not None}, "
                  f"{body}): kernel {ms:.4f} ms ({tflops(10.0 * B_TRAIN * H * seq * seq * D, ms):.1f} TFLOP/s), "
                  f"plain {plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms, "
                  f"bound {bound:.4f} ms by {bound_by} ({bound / ms:.1%} of bound); "
                  f"with the host's time to issue it {host_ms:.4f} ms{note}; {CARD[0]}")
            results[("fused_qkv_attention_backward", shape, name)] = dict(
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound, bound_by=bound_by)
            del qkv, dout, mask, out, q, k, v
            torch.cuda.empty_cache()
    return results


def sdpa_backward_ms(q, k, v, attn_mask, dout, n: int = TIMED_LAUNCHES) -> float:
    """The backward of ``F.scaled_dot_product_attention`` on [B, H, T, D]
    views: forward+backward minus forward (a yardstick the port never calls)."""
    import torch
    import torch.nn.functional as F

    bsz, heads, seq, dim = q.shape
    grad = dout.view(bsz, seq, heads, dim).permute(0, 2, 1, 3)
    inputs = [t for t in (q, k, v, attn_mask) if t is not None and t.is_floating_point() and t.requires_grad]

    def forward():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, scale=dim**-0.5)

    def forward_backward():
        torch.autograd.grad(forward(), inputs, grad)

    with torch.no_grad():
        fwd = median_ms(forward, n)
    return median_ms(forward_backward, n) - fwd


def reset_counts() -> None:
    """Set the launch count of every kernel of the port to 0."""
    from avex_tpu_torch.ops import attention_kernels as ak
    from avex_tpu_torch.ops import int8_kernels as ik

    ak.reset_launch_counts()
    ik.reset_launch_counts()


def read_counts() -> dict:
    """Launches of every kernel of the port since the last reset_counts()."""
    from avex_tpu_torch.ops import attention_kernels as ak
    from avex_tpu_torch.ops import int8_kernels as ik

    return {**ak.LAUNCHES, **ik.LAUNCHES}


def drive(model, label, expect, batches, n_emb, pool, padding_mask=None, body=None):
    """Reset the counts, run warm-up + timed extraction, read the counts.

    ``expect`` maps each kernel the path must launch to its launches per
    forward; every other kernel must launch 0 times. With ``body``
    ("bf16" or "tf32x3") every attention forward must have run on it
    (``attention_kernels.FORWARD_BODIES``); the fp32 runs on 3xTF32 add
    their launches to TF32X3_FORWARD_LAUNCHES. ``pool(features, aux)``
    gives the pooled final features compared across paths. Returns (first
    embeddings, pooled, counts, clips/s).
    """
    import torch

    from avex_tpu_torch.ops import attention_kernels as ak

    reset_counts()
    first = model.extract_embeddings(batches[0], padding_mask=padding_mask, aggregation="mean")
    pooled = pool(*model.module(batches[0], padding_mask)).float()
    torch.cuda.synchronize()
    start = time.perf_counter()
    outs = [model.extract_embeddings(w, padding_mask=padding_mask, aggregation="mean") for w in batches]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    counts = read_counts()
    forwards = len(batches) + 2
    bsz = batches[0].shape[0]
    for emb in [first, *outs]:
        check(tuple(emb.shape) == (bsz, n_emb), f"{label}: embeddings {tuple(emb.shape)} == {(bsz, n_emb)}")
        check(bool(torch.isfinite(emb).all()), f"{label}: embeddings finite")
    for kname in counts:
        per_forward = expect.get(kname, 0)
        check(counts[kname] == per_forward * forwards,
              f"{label}: {kname} launched {counts[kname]} times == {per_forward * forwards} "
              f"({per_forward} per forward x {forwards})")
    if body is not None:
        bodies = {k: v for k, v in ak.FORWARD_BODIES.items() if v}
        total = sum(counts[k] for k in TF32X3_FORWARD_LAUNCHES)
        check(bodies == {body: total}, f"{label}: attention forwards by body {bodies} == { {body: total} }")
        if body == "tf32x3":
            for kname in TF32X3_FORWARD_LAUNCHES:
                TF32X3_FORWARD_LAUNCHES[kname] += counts[kname]
    rate = bsz * len(batches) / elapsed
    print(f"{label}: {rate:.1f} clips/s (B={bsz}, {len(batches)} batches, {elapsed * 1e3:.1f} ms) "
          f"on {torch.cuda.get_device_name(0)}")
    return first, pooled, counts, rate


def compare_paths(label, kernel_pooled, kernel_emb, plain_pooled, plain_emb):
    r1, r2 = rel_l2(kernel_pooled, plain_pooled), rel_l2(kernel_emb, plain_emb)
    check(r1 <= PATH_REL and r2 <= PATH_REL,
          f"{label}: fp32 kernel path vs plain-attention path: pooled rel {r1:.3e}, "
          f"embeddings rel {r2:.3e} <= {PATH_REL:g}")


def beats_config() -> dict:
    """The official ``esp_aves2_sl_beats_all`` init config (12 layers, 768-d)."""
    from avex_tpu_torch.api.official_models import OFFICIAL_MODELS

    return dict(OFFICIAL_MODELS["esp_aves2_sl_beats_all"]["model_spec"]["init_config"])


def load_beats(dtype, quantization=None, **init):
    """Full-width BEATs through ``load_model`` on the card, seeded random
    weights (the same for every call), every layer selected."""
    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec

    spec = ModelSpec(name="beats", pretrained=False, compute_dtype=dtype, init_config=dict(beats_config(), **init))
    model = avex_tpu_torch.load_model(spec, random_weights=True, return_features_only=True, device="cuda",
                                      quantization=quantization)
    model.register_hooks_for_layers(["all"])
    return model


def phase_main_path():
    """Full-width BEATs extraction through the public API; returns launch counts."""
    import torch

    official = beats_config()
    layers = official["encoder_layers"]
    n_emb = (layers + 1) * official["encoder_embed_dim"]

    gen = torch.Generator(device="cuda").manual_seed(1)
    batches = [torch.randn(B, CLIP_SAMPLES, device="cuda", generator=gen) * 0.1 for _ in range(N_BATCHES)]

    def run(model, label, kernel, body=None):
        expect = {kernel: layers} if kernel else {}
        return drive(model, label, expect, batches, n_emb, lambda features, aux: features.mean(dim=1), body=body)

    with torch.no_grad():
        bf16 = load_beats("bfloat16", use_pallas=True)
        emb16, pooled16, counts_split, rate16 = run(bf16, "main bf16 split", "gated_bias_attention", "bf16")
        split_state = {k: v.float().cpu().numpy() for k, v in bf16.state_dict().items()}
        del bf16

        fp32 = load_beats("float32", use_pallas=True)
        emb32, pooled32, _, rate32 = run(fp32, "main fp32 split", "gated_bias_attention", "tf32x3")
        del fp32
        rel = rel_l2(pooled16, pooled32)
        print(f"bf16 vs fp32 pooled features: rel L2 {rel:.3e} (JAX package on a TPU v5e: {TPU_BF16_FP32_REL:g}, "
              f"a reference point, not a target); 13-layer embeddings rel L2 {rel_l2(emb16, emb32):.3e}")
        check(rel < 5e-2, f"bf16 vs fp32 pooled rel L2 {rel:.3e} < 5e-2")

        plain32 = load_beats("float32", use_pallas=False)
        reset_counts()
        ref_pooled = plain32(batches[0]).float().mean(dim=1)
        ref_emb = plain32.extract_embeddings(batches[0], aggregation="mean")
        check(sum(read_counts().values()) == 0, "fp32 plain-attention path launches no kernel")
        del plain32
        compare_paths("BEATs", pooled32, emb32, ref_pooled, ref_emb)

        plain16 = load_beats("bfloat16", use_pallas=None)
        _, plain_pooled16, _, rate_plain16 = run(plain16, "bf16 plain-attention path (use_pallas=None)", None)
        del plain16
        rel_plain = rel_l2(plain_pooled16, ref_pooled)
        print(f"BEATs bf16 vs fp32 pooled features: kernel path rel L2 {rel:.3e}, plain path rel L2 "
              f"{rel_plain:.3e}")

        fused = load_beats("bfloat16", use_pallas=True, fused_qkv=True)
        fused.load_state_dict(split_state, strict=True)  # the split model's weights, q|k|v concatenated
        emb_f, pooled_f, counts_fused, rate_fused = run(fused, "main bf16 fused_qkv", "fused_qkv_gated_attention",
                                                        "bf16")
        rf = rel_l2(pooled_f, pooled16)
        check(rf <= 2e-2, f"bf16 fused_qkv vs split, same weights: pooled rel {rf:.3e} <= 2e-2")
        del fused
    print(json.dumps({
        "model": "beats",
        "clips_per_s": {"bf16_split_kernel": rate16, "fp32_split_kernel": rate32,
                        "bf16_plain_attention": rate_plain16, "bf16_fused_qkv_kernel": rate_fused},
        "bf16_fp32_pooled_rel_l2": {"kernel_path": rel, "plain_path": rel_plain},
        "batch": B, "clip_seconds": CLIP_SAMPLES / 16000,
    }))
    return {"gated_bias_attention": counts_split["gated_bias_attention"],
            "fused_qkv_gated_attention": counts_fused["fused_qkv_gated_attention"]}


def bias_free_main_path(label, load, batches, padding_mask, pool, layers, width):
    """One bias-free model family through the public API: bf16 and fp32 on the
    K5 path, the fp32 plain path against the fp32 kernel path, and the bf16
    plain path; prints the clips/s of each run and each path's bf16-vs-fp32
    pooled distance, and returns K5's launches in the bf16 kernel run."""
    import torch

    n_emb = layers * width

    def run(model, what, kernel, body=None):
        model.register_hooks_for_layers(["all"])
        expect = {kernel: layers} if kernel else {}
        return drive(model, f"{label} {what}", expect, batches, n_emb, pool, padding_mask, body)

    with torch.no_grad():
        emb16, pooled16, counts, rate16 = run(load("bfloat16", True), "bf16 fused_qkv kernel", "fused_qkv_attention",
                                              "bf16")
        emb32, pooled32, _, rate32 = run(load("float32", True), "fp32 fused_qkv kernel", "fused_qkv_attention",
                                         "tf32x3")  # 12 heads of 64: 16-byte rows
        rel = rel_l2(pooled16, pooled32)
        check(rel < 5e-2, f"{label} bf16 vs fp32 pooled rel L2 {rel:.3e} < 5e-2")

        plain32 = load("float32", None)
        plain32.register_hooks_for_layers(["all"])
        reset_counts()
        ref_pooled = pool(*plain32.module(batches[0], padding_mask)).float()
        ref_emb = plain32.extract_embeddings(batches[0], padding_mask=padding_mask, aggregation="mean")
        check(sum(read_counts().values()) == 0, f"{label} fp32 plain-attention path launches no kernel")
        del plain32
        compare_paths(label, pooled32, emb32, ref_pooled, ref_emb)
        _, plain_pooled16, _, rate_plain16 = run(load("bfloat16", None), "bf16 plain-attention path (use_pallas=None)",
                                                 None)
    torch.cuda.empty_cache()
    rel_plain = rel_l2(plain_pooled16, ref_pooled)
    print(f"{label} bf16 vs fp32 pooled features: kernel path rel L2 {rel:.3e} ({layers}-layer embeddings "
          f"{rel_l2(emb16, emb32):.3e}), plain path rel L2 {rel_plain:.3e}")
    print(f"{label} bf16: kernel path {rate16:.1f} clips/s vs plain path {rate_plain16:.1f} clips/s "
          f"({rate16 / rate_plain16:.3f}x)")
    print(json.dumps({
        "model": label.lower(),
        "clips_per_s": {"bf16_fused_qkv_kernel": rate16, "fp32_fused_qkv_kernel": rate32,
                        "bf16_plain_attention": rate_plain16},
        "batch": B, "clip_seconds": batches[0].shape[1] / 16000,
        "bf16_fp32_pooled_rel_l2": {"kernel_path": rel, "plain_path": rel_plain},
    }))
    return counts["fused_qkv_attention"]


def phase_eat():
    """Full-width EAT extraction through the official registry entry."""
    import torch

    import avex_tpu_torch

    def load(dtype, use_pallas):
        return avex_tpu_torch.load_model(
            "esp_aves2_sl_eat_all_ssl_all", random_weights=True, return_features_only=True,
            device="cuda", use_pallas=use_pallas, compute_dtype=dtype,
        )

    gen = torch.Generator(device="cuda").manual_seed(3)
    batches = [torch.randn(B, EAT_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1 for _ in range(N_BATCHES_EAT_AVES)]
    return bias_free_main_path("EAT", load, batches, None, lambda features, aux: aux["pooled"], 12, E)


def phase_aves():
    """Full-width AVES extraction, a third of the clips padded, through a ModelSpec."""
    import torch

    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec
    from avex_tpu_torch.models.beats import downsample_padding_mask

    def load(dtype, use_pallas):
        spec = ModelSpec(name="aves_bio", pretrained=False, compute_dtype=dtype)
        return avex_tpu_torch.load_model(
            spec, random_weights=True, return_features_only=True, device="cuda", use_pallas=use_pallas
        )

    def pool(features, aux):
        valid = (~aux["padding_mask"]).float()[..., None]
        return (features.float() * valid).sum(dim=1) / valid.sum(dim=1)

    gen = torch.Generator(device="cuda").manual_seed(4)
    batches = [torch.randn(B, CLIP_SAMPLES, device="cuda", generator=gen) * 0.1 for _ in range(N_BATCHES_EAT_AVES)]
    mask = torch.zeros(B, CLIP_SAMPLES, dtype=torch.bool, device="cuda")
    mask[::3, AVES_PAD_FROM:] = True
    # The frame mask K5 receives: the fp32 kernel path can only agree with the
    # plain path (which adds the mask as a -inf bias) if the kernel honours it.
    frames = downsample_padding_mask(mask, T_AVES)
    rows, first = int(frames.any(dim=1).sum()), int(frames[0].int().argmax())
    check(rows == len(range(0, B, 3)) and first == 150,
          f"AVES frame mask: {rows} of {B} clips padded from frame {first} of {T_AVES}")
    return bias_free_main_path("AVES", load, batches, mask, pool, 12, E)


def zero_gradient(name, grad):
    """The entries of ``name``'s gradient that are exactly 0 in exact
    arithmetic: the key projection's bias (the third of a fused qkv bias in
    the middle, AVES's ``k_proj.bias`` or RoBERTa's ``k.bias``), which a
    softmax cannot see.
    Computed, they are rounding noise that two correct paths give
    differently."""
    import torch

    noise = torch.zeros_like(grad, dtype=torch.bool)
    if name.endswith(("qkv_proj.bias", "attn.qkv.bias")):
        third = grad.shape[0] // 3
        noise[third:2 * third] = True
    elif name.endswith(("k_proj.bias", ".k.bias")):  # AVES's, BEATs'; CLIP's RoBERTa's
        noise[:] = True
    return noise


def step_gradients(label, load, dtype, use_pallas, wav, mask, expect, timed_steps=0):
    """One step's loss and every parameter's gradient (float32), dropout and
    LayerDrop off; checks the kernel launches (``expect`` on the kernel path,
    none on the plain path) and the body of every forward and backward (bf16,
    or in fp32 the 3xTF32 kernels at every width). With ``timed_steps``, the median host
    ms of that many more steps (forward and backward, synchronised).
    Returns (loss, gradients, launches, ms or None)."""
    import torch

    from avex_tpu_torch.ops import attention_kernels as ak
    from avex_tpu_torch.training.losses import cross_entropy_loss

    labels = torch.arange(wav.shape[0], device=wav.device) % N_CLASSES
    model = load(dtype, use_pallas)
    params = dict(model.module.named_parameters())

    def step():
        out, _ = model.train_forward(wav, mask, deterministic=True)
        loss = cross_entropy_loss(out, labels)
        return loss, torch.autograd.grad(loss, list(params.values()), allow_unused=True)

    reset_counts()
    loss, grads = step()
    torch.cuda.synchronize()
    counts, bodies = read_counts(), {k: v for k, v in ak.BACKWARD_BODIES.items() if v}
    forward_bodies = {k: v for k, v in ak.FORWARD_BODIES.items() if v}
    want = expect if use_pallas else {}
    check(all(counts[k] == want.get(k, 0) for k in counts),
          f"{label} {dtype} gradient check, {'kernel' if use_pallas else 'plain'} path: launches "
          f"{ {k: v for k, v in counts.items() if v} } == {want}")
    backwards = sum(want.get(k, 0) for k in TF32X3_STEP_LAUNCHES)
    want_bodies = {("bf16" if dtype == "bfloat16" else "tf32x3"): backwards} if backwards else {}
    check(bodies == want_bodies, f"{label} {dtype} gradient check, {'kernel' if use_pallas else 'plain'} path: "
                                 f"backward bodies {bodies} == {want_bodies}")
    forwards = sum(want.get(k, 0) for k in TF32X3_FORWARD_LAUNCHES)
    want_forward = {("bf16" if dtype == "bfloat16" else "tf32x3"): forwards} if forwards else {}
    check(forward_bodies == want_forward, f"{label} {dtype} gradient check, "
                                          f"{'kernel' if use_pallas else 'plain'} path: forward bodies "
                                          f"{forward_bodies} == {want_forward}")
    if dtype == "float32" and use_pallas:
        for kname in TF32X3_STEP_LAUNCHES:
            TF32X3_STEP_LAUNCHES[kname] += counts[kname]
        for kname in TF32X3_FORWARD_LAUNCHES:
            TF32X3_FORWARD_LAUNCHES[kname] += counts[kname]
    ms = None
    if timed_steps:
        times = []
        for _ in range(timed_steps):
            start = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
        ms = statistics.median(times) * 1e3
    result = loss.item(), {n: g.float() for n, g in zip(params, grads) if g is not None}, counts, ms
    del model, params, grads
    torch.cuda.empty_cache()
    return result


def gradient_distance(grads, ref) -> tuple:
    """(global rel L2 over every gradient, worst single tensor's rel L2, its
    name) of ``grads`` against ``ref``, ``zero_gradient`` entries left out."""
    num = den = worst = 0.0
    worst_name = None
    for name, want in ref.items():
        keep = ~zero_gradient(name, want)
        diff2, norm2 = float((grads[name][keep] - want[keep]).norm() ** 2), float(want[keep].norm() ** 2)
        num, den = num + diff2, den + norm2
        rel = (diff2 / norm2) ** 0.5 if norm2 else diff2 ** 0.5
        if rel > worst:
            worst, worst_name = rel, name
    return (num / den) ** 0.5, worst, worst_name


def training_gradient_check(label, load, wav, expect, mask=None, bf16=False, timed_steps=0):
    """fp32, dropout and LayerDrop off, the same weights: the kernel path's
    loss and every parameter's gradient against the plain path's, every
    fp32 forward and backward on "tf32x3". ``expect`` maps the kernels the
    kernel path launches to their count. With ``timed_steps`` each path's fp32 step is
    also timed (the median of that many). With ``bf16`` one bf16 step of each
    path is also held to the fp32 plain path: the kernel path may be at most
    BF16_GRAD_FACTOR farther than the plain path (global rel L2 over every
    gradient). Returns the numbers printed."""
    loss_k, grads_k, counts_k, ms_k = step_gradients(label, load, "float32", True, wav, mask, expect, timed_steps)
    loss_p, grads_p, _, ms_p = step_gradients(label, load, "float32", False, wav, mask, expect, timed_steps)
    check(grads_k.keys() == grads_p.keys(), f"{label}: the same parameters get gradients on both paths")
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    _, worst, worst_name = gradient_distance(grads_k, grads_p)
    check(loss_rel <= PATH_REL and worst <= PATH_REL,
          f"{label}: fp32 kernel path vs plain path, one step (B={wav.shape[0]}): loss rel {loss_rel:.3e}, "
          f"worst gradient rel L2 {worst:.3e} ({worst_name}) over {len(grads_p)} tensors <= {PATH_REL:g}")
    result = {"fp32_loss_rel": loss_rel, "fp32_worst_grad_rel": worst,
              "kernel_path_launches": {k: v for k, v in counts_k.items() if v}}
    if timed_steps:
        print(f"{label} fp32 step (B={wav.shape[0]}, forward and backward, median of {timed_steps}): kernel path "
              f"{ms_k:.1f} ms (forward and backward on tf32x3), plain path {ms_p:.1f} ms; "
              f"{CARD[0]}")
        result["fp32_step_ms"] = {"kernel_path": ms_k, "plain_path": ms_p}
    if bf16:
        del grads_k
        dist = {}
        for path, use_pallas in (("kernel", True), ("plain", False)):
            loss16, grads16, _, _ = step_gradients(label, load, "bfloat16", use_pallas, wav, mask, expect)
            check(grads16.keys() == grads_p.keys(), f"{label} bf16 {path} path: the same parameters get gradients")
            dist[path] = (abs(loss16 - loss_p) / abs(loss_p), *gradient_distance(grads16, grads_p))
            del grads16
        (lk, gk, wk, nk), (lp, gp, wp, np_) = dist["kernel"], dist["plain"]
        print(f"{label} bf16 step vs the fp32 plain path (B={wav.shape[0]}): kernel path loss rel {lk:.3e}, "
              f"gradients global rel L2 {gk:.3e} (worst tensor {wk:.3e}, {nk}); plain path loss rel {lp:.3e}, "
              f"gradients global rel L2 {gp:.3e} (worst tensor {wp:.3e}, {np_})")
        check(gk <= BF16_GRAD_FACTOR * gp,
              f"{label}: bf16 kernel path's gradients {gk:.3e} from fp32 <= {BF16_GRAD_FACTOR:g} x the bf16 plain "
              f"path's {gp:.3e}")
        result.update(bf16_grad_rel={"kernel_path": gk, "plain_path": gp},
                      bf16_loss_rel={"kernel_path": lk, "plain_path": lp})
    return result


def train_run(label, model, batch, expect, steps, workdir, label_type="supervised", lr=3e-4):
    """``Trainer`` steps on one batch: counts reset just before and read just
    after the timed steps. Returns (trainer, losses, ms per step, clips/s,
    peak bytes, counts)."""
    import torch

    from avex_tpu_torch.configs import RunConfig, SchedulerConfig, TrainingParams
    from avex_tpu_torch.training import Trainer

    bsz = batch["raw_wav"].shape[0]
    config = RunConfig(
        model_spec={"name": label},
        training_params=TrainingParams(train_epochs=1, lr=lr, batch_size=bsz, optimizer="adamw",
                                       weight_decay=0.01),
        scheduler=SchedulerConfig(name="cosine", warmup_steps=2),
        output_dir=str(workdir), seed=0, label_type=label_type,
        loss_function="clip" if label_type == "text" else "cross_entropy",
    )
    trainer = Trainer(model, config, [batch], steps_per_epoch=steps + 10)
    losses = [trainer._train_step(batch)[0]]  # untimed: the first step's allocations
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = time.perf_counter()
    for _ in range(steps):
        losses.append(trainer._train_step(batch)[0])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    for kname in counts:
        per_step = expect.get(kname, 0)
        check(counts[kname] == per_step * steps,
              f"{label} training: {kname} launched {counts[kname]} times == {per_step * steps} "
              f"({per_step} per step x {steps})")
    check(all(map(lambda x: x == x and abs(x) != float("inf"), losses)), f"{label} training: every loss finite")
    ms = elapsed / steps * 1e3
    print(f"{label} training: {bsz * steps / elapsed:.1f} clips/s, {ms:.1f} ms per step (B={bsz}, "
          f"{steps} steps), peak {peak / 2**30:.2f} GiB on {torch.cuda.get_device_name(0)}; losses "
          + " ".join(f"{x:.4f}" for x in losses))
    return trainer, losses, ms, bsz * steps / elapsed, peak, counts


def phase_beats_training(workdir):
    """Full-width BEATs fine-tuning through ``Trainer``; returns the K2 and K3
    launches of the timed run."""
    import torch

    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec

    layers = beats_config()["encoder_layers"]

    def load(dtype, use_pallas):
        spec = ModelSpec(name="beats", pretrained=False, compute_dtype=dtype,
                         init_config=dict(beats_config(), fused_qkv=True, use_pallas=use_pallas))
        return avex_tpu_torch.load_model(spec, random_weights=True, num_classes=N_CLASSES, device="cuda")

    gen = torch.Generator(device="cuda").manual_seed(9)
    batch = {"raw_wav": torch.randn(B_TRAIN, CLIP_SAMPLES, device="cuda", generator=gen) * 0.1,
             "label": torch.randint(0, N_CLASSES, (B_TRAIN,), device="cuda", generator=gen)}
    model = load("bfloat16", True)
    cfg = model.cfg
    print(f"BEATs training config: dropout {cfg.dropout}, activation_dropout {cfg.activation_dropout}, "
          f"encoder_layerdrop {cfg.encoder_layerdrop}, dropout_input {cfg.dropout_input}")
    expect = {"fused_qkv_gated_attention": layers, "fused_qkv_gated_attention_backward": layers}
    trainer, losses, ms, rate, peak, counts = train_run("beats", model, batch, expect, TRAIN_STEPS, workdir)
    check(sum(losses[-3:]) / 3 < losses[0], f"BEATs training: the loss falls on one repeated batch "
                                            f"({losses[0]:.4f} -> mean of the last 3 {sum(losses[-3:]) / 3:.4f})")

    model.enable_gradient_checkpointing()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    trainer._train_step(batch)
    torch.cuda.synchronize()
    remat_counts, remat_peak = read_counts(), torch.cuda.max_memory_allocated()
    remat_expect = {"fused_qkv_gated_attention": 2 * layers, "fused_qkv_gated_attention_backward": layers}
    check(all(remat_counts[k] == remat_expect.get(k, 0) for k in remat_counts),
          f"BEATs training, gradient checkpointing: launches { {k: v for k, v in remat_counts.items() if v} } "
          f"== {remat_expect} (the forward runs again in the backward)")
    print(f"BEATs training with gradient checkpointing: peak {remat_peak / 2**30:.2f} GiB vs {peak / 2**30:.2f} GiB")
    del trainer, model
    torch.cuda.empty_cache()

    grad_check = training_gradient_check("BEATs", load, batch["raw_wav"][:B_GRAD_CHECK], expect, bf16=True,
                                         timed_steps=FP32_TIMED_STEPS)
    print(json.dumps({"model": "beats", "training": {
        "clips_per_s": rate, "ms_per_step": ms, "peak_bytes": peak, "remat_peak_bytes": remat_peak,
        "losses": losses, **grad_check},
        "batch": B_TRAIN, "clip_seconds": CLIP_SAMPLES / 16000, "num_classes": N_CLASSES}))
    return counts


def phase_eat_training(workdir):
    """Full-width EAT fine-tuning through ``Trainer``; returns the K5 and K6
    launches of the timed run."""
    import torch

    import avex_tpu_torch

    def load(dtype, use_pallas):
        return avex_tpu_torch.load_model("esp_aves2_sl_eat_all_ssl_all", random_weights=True, num_classes=N_CLASSES,
                                         device="cuda", use_pallas=use_pallas, compute_dtype=dtype)

    gen = torch.Generator(device="cuda").manual_seed(10)
    batch = {"raw_wav": torch.randn(B_TRAIN, EAT_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1,
             "label": torch.randint(0, N_CLASSES, (B_TRAIN,), device="cuda", generator=gen)}
    expect = {"fused_qkv_attention": 12, "fused_qkv_attention_backward": 12}
    trainer, losses, ms, rate, peak, counts = train_run("eat_hf", load("bfloat16", True), batch, expect,
                                                        TRAIN_STEPS, workdir)
    check(sum(losses[-3:]) / 3 < losses[0], f"EAT training: the loss falls on one repeated batch "
                                           f"({losses[0]:.4f} -> mean of the last 3 {sum(losses[-3:]) / 3:.4f})")
    del trainer
    torch.cuda.empty_cache()
    grad_check = training_gradient_check("EAT", reused_paths(lambda dtype: load(dtype, True)),
                                         batch["raw_wav"][:B_GRAD_CHECK], expect, bf16=True,
                                         timed_steps=FP32_TIMED_STEPS)
    print(json.dumps({"model": "eat", "training": {
        "clips_per_s": rate, "ms_per_step": ms, "peak_bytes": peak, "losses": losses, **grad_check},
        "batch": B_TRAIN, "clip_seconds": EAT_CLIP_SAMPLES / 16000, "num_classes": N_CLASSES}))
    return counts


def phase_aves_training(workdir):
    """``aves_bio`` fine-tuning through ``Trainer`` with its dropout and
    LayerDrop, a third of the clips padded (K5 and the masked K6, 12 launches
    each a step); then the fp32 and bf16 gradient checks. Returns the K5 and
    K6 launches of the timed run."""
    import torch

    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec
    from avex_tpu_torch.training import make_strategy

    def load(dtype, use_pallas):
        spec = ModelSpec(name="aves_bio", pretrained=False, compute_dtype=dtype)
        return avex_tpu_torch.load_model(spec, random_weights=True, num_classes=N_CLASSES, device="cuda",
                                         use_pallas=use_pallas)

    gen = torch.Generator(device="cuda").manual_seed(11)
    mask = torch.zeros(B_TRAIN, CLIP_SAMPLES, dtype=torch.bool, device="cuda")
    mask[::3, AVES_PAD_FROM:] = True
    batch = {"raw_wav": torch.randn(B_TRAIN, CLIP_SAMPLES, device="cuda", generator=gen) * 0.1,
             "padding_mask": mask, "label": torch.randint(0, N_CLASSES, (B_TRAIN,), device="cuda", generator=gen)}
    expect = {"fused_qkv_attention": 12, "fused_qkv_attention_backward": 12}
    model = load("bfloat16", True)
    cfg = model.config
    print(f"AVES training config: encoder_dropout {cfg.encoder_dropout}, encoder_projection_dropout "
          f"{cfg.encoder_projection_dropout}, encoder_ff_interm_dropout {cfg.encoder_ff_interm_dropout}, "
          f"encoder_layer_drop {cfg.encoder_layer_drop}")
    trainer, losses, ms, rate, peak, counts = train_run("aves_bio", model, batch, expect, TRAIN_STEPS, workdir)
    check(sum(losses[-3:]) / 3 < losses[0], f"AVES training: the loss falls on one repeated batch "
                                           f"({losses[0]:.4f} -> mean of the last 3 {sum(losses[-3:]) / 3:.4f})")
    # Dropout and LayerDrop reach the model in training: the loss depends on
    # the generator's seed, and one seed gives one loss.
    strategy = make_strategy("supervised", "cross_entropy")
    with torch.no_grad():
        drawn = [strategy.forward_loss(model.train_forward, batch, torch.Generator(device="cuda").manual_seed(s),
                                       train=True)[0].item() for s in (1, 1, 2)]
    same, other = abs(drawn[1] - drawn[0]) / abs(drawn[0]), abs(drawn[2] - drawn[0]) / abs(drawn[0])
    check(same <= 1e-5 < 1e-3 <= other,
          f"AVES training: dropout draws from the step's generator: the loss of seed 1 twice {drawn[0]:.6f}, "
          f"{drawn[1]:.6f} (rel {same:.1e} <= 1e-5), of seed 2 {drawn[2]:.6f} (rel {other:.1e} >= 1e-3)")
    del trainer, model
    torch.cuda.empty_cache()
    grad_check = training_gradient_check("AVES", load, batch["raw_wav"][:B_GRAD_CHECK], expect,
                                         mask=mask[:B_GRAD_CHECK], bf16=True)
    print(json.dumps({"model": "aves", "training": {
        "clips_per_s": rate, "ms_per_step": ms, "peak_bytes": peak, "losses": losses, **grad_check},
        "batch": B_TRAIN, "clip_seconds": CLIP_SAMPLES / 16000, "num_classes": N_CLASSES}))
    return counts


def phase_dh80_kernels():
    """K5 and K4 at Bird-MAE huge's forward shape (B=128, T=513, 16 heads of
    80) and K6 at its training batch, in bf16 (tensor cores) and fp32 (3xTF32
    forward and K6), against their twins (the bf16 K6 also against the twin of its own
    contract on K5's saved residuals); returns per-kernel numbers for the
    JSON line and K4's launches in this phase."""
    import torch
    import torch.nn.functional as F

    from avex_tpu_torch.ops import attention_kernels as ak

    gen = torch.Generator(device="cuda").manual_seed(13)
    results = {}
    ak.reset_launch_counts()

    def held(label, dtype, got, want):
        """finite; fp32 max|d| or bf16 relative L2 against the twin; returns max|d|."""
        err, rel = float((got.float() - want.float()).abs().max()), rel_l2(got, want)
        check(bool(torch.isfinite(got).all()), f"{label}: finite")
        if dtype == torch.float32:
            check(err <= FP32_ATOL, f"{label}: max|d|={err:.3e} <= {FP32_ATOL:g} (rel {rel:.3e})")
        else:
            check(rel <= BF16_REL_L2, f"{label}: rel L2={rel:.3e} <= {BF16_REL_L2:g} (max|d| {err:.3e})")
        return err

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        fp32 = dtype == torch.float32
        body = "tensor cores, 3xTF32" if fp32 else "tensor cores"
        qkv = torch.randn(B, T_MAE, 3 * E_MAE, device="cuda", generator=gen).to(dtype)
        q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(B, T_MAE, 3, H_MAE, D_MAE).unbind(2))
        cases = (
            ("fused_qkv_attention", lambda: ak.fused_qkv_attention(qkv, H_MAE),
             lambda: ak.fused_qkv_reference(qkv, H_MAE)),
            ("plain_attention", lambda: ak.gated_bias_attention(q, k, v, None),
             lambda: ak.gated_bias_attention_reference(q, k, v, None)),
        )
        with torch.no_grad():
            for kname, run, twin in cases:
                label = f"{kname} Bird-MAE huge dh={D_MAE} B={B} T={T_MAE} {name}"
                got, bodies = bodies_of(run, forward=True)
                check(bodies == {"tf32x3" if fp32 else "bf16": 1}, f"{label}: ran on the {list(bodies)} body")
                err = fp32_forward_held(label, got, twin()) if fp32 else held(label, dtype, got, twin())
                del got
                ms, plain_ms = median_ms(run), median_ms(twin)
                library_ms = median_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=D_MAE**-0.5))
                bound, bound_by = attention_bound_ms(name, gated=False, padded=False, seq=T_MAE, heads=H_MAE,
                                                     dim=D_MAE, tf32x3=fp32)
                fp32_numbers, note = fp32_forward_timing(q, k, v) if fp32 else ({}, "")
                print(f"time {label} ({body}): kernel {ms:.4f} ms "
                      f"({tflops(4.0 * B * H_MAE * T_MAE * T_MAE * D_MAE, ms):.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
                      f"sdpa {library_ms:.4f} ms, bound {bound:.4f} ms by {bound_by} ({bound / ms:.1%} of bound)"
                      f"{note}; {CARD[0]}")
                results[(kname, name)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                              bound_ms=bound, bound_by=bound_by, batch=B, seq=T_MAE, heads=H_MAE,
                                              **fp32_numbers)
            if fp32:
                lse_held(f"fused_qkv_attention Bird-MAE huge dh={D_MAE} B={B} T={T_MAE} {name}", qkv, H_MAE)
        del qkv, q, k, v
        torch.cuda.empty_cache()

        qkv = torch.randn(B_TRAIN_MAE, T_MAE, 3 * E_MAE, device="cuda", generator=gen).to(dtype).requires_grad_()
        dout = torch.randn(B_TRAIN_MAE, T_MAE, E_MAE, device="cuda", generator=gen).to(dtype)
        out = ak.fused_qkv_attention(qkv, H_MAE)
        (got,), bodies = bodies_of(lambda: torch.autograd.grad(out, (qkv,), dout, retain_graph=True))
        label = f"fused_qkv_attention_backward Bird-MAE huge dh={D_MAE} B={B_TRAIN_MAE} T={T_MAE} {name}"
        want = ak.fused_qkv_backward_reference(qkv.detach(), H_MAE, None, dout)
        err = held(label, dtype, got, want)
        check(bodies == {"tf32x3" if fp32 else "bf16": 1}, f"{label}: ran on the {list(bodies)} body")
        if fp32:
            rel = rel_l2(got, want)
            check(rel <= TF32X3_REL_L2, f"{label}: rel L2={rel:.3e} <= {TF32X3_REL_L2:g} (3xTF32)")
        del want
        if dtype == torch.bfloat16:
            *_, saved_out, rest, lse = out.grad_fn.saved_tensors  # K5's residuals
            own = ak.fused_qkv_backward_from_residuals_reference(qkv.detach(), saved_out.detach(), lse, None,
                                                                 dout, out_rest=rest)[0]
            held(label + " vs its residual twin", dtype, got, own)
            del own, saved_out, rest, lse
        del got
        ms = median_ms(lambda: torch.autograd.grad(out, (qkv,), dout, retain_graph=True))
        plain_ms = median_ms(lambda: ak.fused_qkv_backward_reference(qkv.detach(), H_MAE, None, dout))
        q, k, v = (t.detach().permute(0, 2, 1, 3).requires_grad_()
                   for t in qkv.detach().view(B_TRAIN_MAE, T_MAE, 3, H_MAE, D_MAE).unbind(2))
        library_ms = sdpa_backward_ms(q, k, v, None, dout)
        bound, bound_by = backward_bound_ms(name, B_TRAIN_MAE, T_MAE, gated=False, padded=False, heads=H_MAE,
                                            dim=D_MAE, tf32x3=fp32)
        note = fp32_backward_note(ms, B_TRAIN_MAE, T_MAE, H_MAE, D_MAE) if fp32 else ""
        print(f"time {label} ({'tensor cores, 3xTF32' if fp32 else body}): kernel {ms:.4f} ms "
              f"({tflops(10.0 * B_TRAIN_MAE * H_MAE * T_MAE * T_MAE * D_MAE, ms):.1f} TFLOP/s), "
              f"plain {plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms, bound {bound:.4f} ms by {bound_by} "
              f"({bound / ms:.1%} of bound){note}; {CARD[0]}")
        results[("fused_qkv_attention_backward", name)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound, bound_by=bound_by,
            batch=B_TRAIN_MAE, seq=T_MAE, heads=H_MAE)
        del qkv, dout, out, q, k, v
        torch.cuda.empty_cache()
    k4_launches = ak.LAUNCHES["plain_attention"]
    print(f"plain_attention (K4) launched {k4_launches} times in the dh-80 phase")
    return results, k4_launches


def load_birdmae(dtype, use_pallas, model_id=MAE_HUGE, **kwargs):
    """Full-width Bird-MAE through ``load_model`` and a ModelSpec whose
    ``model_id`` names the variant, ``use_pallas`` through ``init_config``;
    seeded random weights, the same for every call."""
    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec

    spec = ModelSpec(name="birdmae", pretrained=False, model_id=model_id, compute_dtype=dtype,
                     init_config={"use_pallas": use_pallas})
    return avex_tpu_torch.load_model(spec, random_weights=True, device="cuda", **kwargs)


def phase_birdmae():
    """Full-width Bird-MAE huge extraction (10 s clips at 32 kHz, all 32 layers
    mean-pooled): bf16 on K5 and on the plain path at B=128, the fp32 kernel
    path against the fp32 plain path at B=8 (pooled and every tapped layer),
    then Bird-MAE base (dh 64) for one batch. Returns K5's launches in the two
    bf16 kernel runs."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(12)
    batches = [torch.randn(B, MAE_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1 for _ in range(N_BATCHES_MAE)]
    small = [batches[0][:B_MAE_FP32]]

    def pool(features, aux):
        return aux["pooled"]

    def run(model, what, kernel, data, layers=MAE_LAYERS, width=E_MAE):
        model.register_hooks_for_layers(["all"])
        return drive(model, f"Bird-MAE {what}", {kernel: layers} if kernel else {}, data, layers * width, pool)

    def shape_of(model):
        blocks = model.module.blocks
        return len(blocks), blocks[0].dim, blocks[0].heads

    with torch.no_grad():
        start = time.perf_counter()
        model = load_birdmae("bfloat16", True, return_features_only=True)
        build_s = time.perf_counter() - start
        check(shape_of(model) == (MAE_LAYERS, E_MAE, H_MAE),
              f"Bird-MAE huge from model_id: (blocks, dim, heads) {shape_of(model)} == {(MAE_LAYERS, E_MAE, H_MAE)}")
        torch.cuda.reset_peak_memory_stats()
        emb16, pooled16, counts, rate16 = run(model, "huge bf16 K5", "fused_qkv_attention", batches)
        peak16 = torch.cuda.max_memory_allocated()
        del model
        torch.cuda.empty_cache()
        _, plain16, _, rate_plain16 = run(load_birdmae("bfloat16", None, return_features_only=True),
                                          "huge bf16 plain-attention path (use_pallas=None)", None, batches)
        torch.cuda.empty_cache()

        kernel32 = load_birdmae("float32", True, return_features_only=True)
        _, pooled32, _, rate32 = run(kernel32, f"huge fp32 K5 (B={B_MAE_FP32})", "fused_qkv_attention", small)
        layers32 = kernel32.extract_embeddings(small[0], aggregation="none")
        del kernel32
        plain32 = load_birdmae("float32", None, return_features_only=True)
        plain32.register_hooks_for_layers(["all"])
        reset_counts()
        ref_pooled = plain32.module(small[0])[1]["pooled"].float()
        ref_layers = plain32.extract_embeddings(small[0], aggregation="none")
        check(sum(read_counts().values()) == 0, "Bird-MAE huge fp32 plain-attention path launches no kernel")
        del plain32
        rp = rel_l2(pooled32, ref_pooled)
        layer_rel = [rel_l2(a, b) for a, b in zip(layers32, ref_layers)]
        check(len(layer_rel) == MAE_LAYERS and rp <= PATH_REL and max(layer_rel) <= PATH_REL,
              f"Bird-MAE huge: fp32 kernel path vs plain-attention path (B={B_MAE_FP32}): pooled rel {rp:.3e}, "
              f"worst of {len(layer_rel)} tapped layers rel {max(layer_rel):.3e} "
              f"(layer {layer_rel.index(max(layer_rel))}) <= {PATH_REL:g}")
        del layers32, ref_layers
        torch.cuda.empty_cache()
        rel = rel_l2(pooled16[:B_MAE_FP32], pooled32)
        rel_plain = rel_l2(plain16[:B_MAE_FP32], ref_pooled)
        check(rel < 5e-2, f"Bird-MAE huge bf16 vs fp32 pooled rel L2 {rel:.3e} < 5e-2")

        base = load_birdmae("bfloat16", True, MAE_BASE, return_features_only=True)
        check(shape_of(base) == (12, 768, 12), f"Bird-MAE base from model_id: {shape_of(base)} == (12, 768, 12)")
        _, _, base_counts, base_rate = run(base, "base bf16 K5 (dh 64)", "fused_qkv_attention", batches[:1],
                                           12, 768)
        del base
    torch.cuda.empty_cache()
    print(f"Bird-MAE huge bf16 vs fp32 pooled features (B={B_MAE_FP32}): kernel path rel L2 {rel:.3e}, plain path "
          f"rel L2 {rel_plain:.3e}; bf16 kernel path {rate16:.1f} clips/s vs plain path {rate_plain16:.1f} clips/s "
          f"({rate16 / rate_plain16:.3f}x); peak {peak16 / 2**30:.2f} GiB; model built in {build_s:.1f} s; "
          f"{CARD[0]}")
    print(json.dumps({
        "model": "birdmae_huge",
        "clips_per_s": {"bf16_fused_qkv_kernel": rate16, "bf16_plain_attention": rate_plain16,
                        f"fp32_fused_qkv_kernel_b{B_MAE_FP32}": rate32, "base_bf16_fused_qkv_kernel": base_rate},
        "batch": B, "clip_seconds": MAE_CLIP_SAMPLES / 32000, "peak_bytes_bf16": peak16,
        "bf16_fp32_pooled_rel_l2": {"kernel_path": rel, "plain_path": rel_plain},
        "fp32_kernel_vs_plain": {"pooled_rel": rp, "worst_layer_rel": max(layer_rel)},
    }))
    return counts["fused_qkv_attention"] + base_counts["fused_qkv_attention"]


def reused_paths(build):
    """A loader for ``training_gradient_check`` that builds each type's model
    once (``build(dtype)``, seeded: the same weights either way) and sets its
    blocks' ``use_pallas`` for the path asked: a gradient check steps no
    optimizer, and a full-width build on the host costs seconds."""
    built = {}

    def load(dtype, use_pallas):
        model = built[dtype] if dtype in built else built.setdefault(dtype, build(dtype))
        for block in model.module.blocks:
            block.use_pallas = bool(use_pallas)
        return model

    return load


def phase_birdmae_training(workdir):
    """Full-width Bird-MAE huge fine-tuning through ``Trainer`` (bf16, K5 and
    K6 at dh 80, 32 launches each a step), one step under the profiler for the
    device's busy share, then the fp32 and bf16 gradient checks at B=8 (each
    type built once for both paths). Returns the K5 and K6 launches of the
    timed run."""
    import torch

    def load(dtype, use_pallas):
        return load_birdmae(dtype, use_pallas, num_classes=N_CLASSES)

    gen = torch.Generator(device="cuda").manual_seed(14)
    batch = {"raw_wav": torch.randn(B_TRAIN_MAE, MAE_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1,
             "label": torch.randint(0, N_CLASSES, (B_TRAIN_MAE,), device="cuda", generator=gen)}
    expect = {"fused_qkv_attention": MAE_LAYERS, "fused_qkv_attention_backward": MAE_LAYERS}
    trainer, losses, ms, rate, peak, counts = train_run("birdmae", load("bfloat16", True), batch, expect,
                                                        MAE_TRAIN_STEPS, workdir)
    wall_ms, busy = busy_share(lambda: trainer._train_step(batch))
    print(f"Bird-MAE huge training step under the profiler: {wall_ms:.1f} ms, device busy {busy:.1%}; "
          f"peak {peak / 2**30:.2f} GiB (B={B_TRAIN_MAE}); {CARD[0]}")
    del trainer
    torch.cuda.empty_cache()
    grad_check = training_gradient_check("Bird-MAE huge", reused_paths(lambda dtype: load(dtype, True)),
                                         batch["raw_wav"][:B_GRAD_CHECK], expect, bf16=True)
    print(json.dumps({"model": "birdmae_huge", "training": {
        "clips_per_s": rate, "ms_per_step": ms, "peak_bytes": peak, "profiled_step_ms": wall_ms,
        "device_busy_share": busy, "losses": losses, **grad_check},
        "batch": B_TRAIN_MAE, "clip_seconds": MAE_CLIP_SAMPLES / 32000, "num_classes": N_CLASSES}))
    return counts


def phase_atst_training(workdir):
    """Full-width ATST-Frame fine-tuning through ``Trainer`` (bf16, 10 s
    clips, K5 and K6 at dh 64, 12 launches each a step), then the fp32 and
    bf16 gradient checks at B=8. Returns the K5 and K6 launches of the timed
    run."""
    import torch

    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec

    def load(dtype, use_pallas):
        spec = ModelSpec(name="atst", pretrained=False, compute_dtype=dtype)
        return avex_tpu_torch.load_model(spec, random_weights=True, num_classes=N_CLASSES, device="cuda",
                                         use_pallas=use_pallas)

    gen = torch.Generator(device="cuda").manual_seed(16)
    batch = {"raw_wav": torch.randn(B_TRAIN, ATST_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1,
             "label": torch.randint(0, N_CLASSES, (B_TRAIN,), device="cuda", generator=gen)}
    expect = {"fused_qkv_attention": 12, "fused_qkv_attention_backward": 12}
    trainer, losses, ms, rate, peak, counts = train_run("atst", load("bfloat16", True), batch, expect,
                                                        TRAIN_STEPS, workdir)
    check(sum(losses[-3:]) / 3 < losses[0], f"ATST training: the loss falls on one repeated batch "
                                           f"({losses[0]:.4f} -> mean of the last 3 {sum(losses[-3:]) / 3:.4f})")
    del trainer
    torch.cuda.empty_cache()
    grad_check = training_gradient_check("ATST", load, batch["raw_wav"][:B_GRAD_CHECK], expect, bf16=True)
    print(json.dumps({"model": "atst", "training": {
        "clips_per_s": rate, "ms_per_step": ms, "peak_bytes": peak, "losses": losses, **grad_check},
        "batch": B_TRAIN, "clip_seconds": ATST_CLIP_SAMPLES / 16000, "num_classes": N_CLASSES}))
    return counts


def phase_atst():
    """Full-width ATST-Frame extraction (10 s clips at 16 kHz, T=250): the
    card's frontend against the CPU's (both precisions), the timestamp
    embedding's shape, then K5 (12 launches a forward) in bf16 and fp32
    against the plain path. Returns K5's launches in the bf16 kernel run."""
    import torch

    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec
    from avex_tpu_torch.models.atst import atst_frontend

    def load(dtype, use_pallas):
        spec = ModelSpec(name="atst", pretrained=False, compute_dtype=dtype)
        return avex_tpu_torch.load_model(spec, random_weights=True, return_features_only=True, device="cuda",
                                         use_pallas=use_pallas)

    gen = torch.Generator(device="cuda").manual_seed(15)
    batches = [torch.randn(B, ATST_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1 for _ in range(N_BATCHES_EAT_AVES)]
    wav = batches[0][:8]
    card, cpu = atst_frontend(wav), atst_frontend(wav.cpu())
    r = rel_l2(card.cpu(), cpu)
    check(card.shape == (8, 64, 1001) and r <= FRONTEND_CARD_CPU_REL,
          f"ATST fp32 frontend on the card vs the CPU: {tuple(card.shape)}, rel L2 {r:.3e} <= {FRONTEND_CARD_CPU_REL:g}")
    r = rel_l2(atst_frontend(wav, "default").cpu(), atst_frontend(wav.cpu(), "default"))
    check(r <= FRONTEND_CARD_CPU_REL, f"ATST bf16-operand frontend, TF32 product on the card vs fp32 on the CPU: "
                                      f"rel L2 {r:.3e} <= {FRONTEND_CARD_CPU_REL:g}")
    with torch.no_grad():
        model = load("bfloat16", True)
        _, aux = model.module(batches[0])
        shape = tuple(aux["timestamp_embedding"].shape)
        check(shape == (B, T_ATST, 12 * E) and bool(torch.isfinite(aux["timestamp_embedding"]).all()),
              f"ATST timestamp_embedding {shape} == {(B, T_ATST, 12 * E)}, finite")
        del model, aux
    return bias_free_main_path("ATST", load, batches, None, lambda features, aux: aux["pooled"], 12, E)


def max_ulps(got, want, mantissa_bits: int) -> float:
    """Largest |got - want| in units of the last place of ``want`` (24
    significand bits for float32, 8 for bfloat16)."""
    import torch

    g, w = got.double(), want.double()
    _, exponent = torch.frexp(w.abs().clamp_min(1e-30))
    ulp = torch.ldexp(torch.ones_like(w), exponent - mantissa_bits)
    return float(((g - w).abs() / ulp).max())


def int8_bound_ms(m: int, k: int, n: int, x_bytes: int, out_bytes: int, bias: bool) -> tuple:
    """Least time for one int8 dense on the card: x, the int8 weight, its
    scales (and bias) read once, the output written once; 2·M·K·N int8
    operations at the dense int8 tensor-core rate."""
    nbytes = m * k * x_bytes + n * k + n * 4 * (2 if bias else 1) + m * n * out_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * m * k * n / PEAK_INT8_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_int8_kernels():
    """K7 and K8 against their twins at BEATs' shapes; returns the numbers of
    the JSON line and K8's launches (no model reaches K8: the kernel phase is
    where it runs)."""
    import torch
    import torch.nn.functional as F

    from avex_tpu_torch.ops import int8_kernels as ik
    from avex_tpu_torch.quant import quantize_kernel

    gen = torch.Generator(device="cuda").manual_seed(5)
    reset_counts()
    worst = {"bfloat16": 0.0, "float32": 0.0}
    timed = {}
    with torch.no_grad():
        for name, (k, n) in INT8_SHAPES.items():
            weight = torch.randn(n, k, device="cuda", generator=gen) / k**0.5
            wq, scale = quantize_kernel(weight)
            bias = torch.randn(n, device="cuda", generator=gen) * 0.02
            for m in (M_FULL, M_ONE):
                for dtype in (torch.bfloat16, torch.float32):
                    dname = str(dtype).split(".")[1]
                    x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
                    x[m // 3] = 0.0  # an all-zero row: the 1e-8 scale guard
                    # K7's two kernels, each against its own twin, exactly
                    xq, row_scale = ik._quantize_rows_kernel(x)
                    levels, want_scale = ik.quantize_rows(x)
                    torch.cuda.synchronize()
                    check(torch.equal(xq, levels.to(torch.int8)) and torch.equal(row_scale, want_scale[:, 0]),
                          f"int8 row quantization {name} M={m} {dname}: levels and scales exactly the twin's")
                    for b in (None, bias):
                        product = ik._scaled_product_kernel(xq, row_scale, wq, scale, b, dtype)
                        torch.cuda.synchronize()
                        check(torch.equal(product, ik.scaled_product_reference(xq, row_scale, wq, scale, b, dtype)),
                              f"int8 scaled product {name} M={m} {dname} bias={b is not None}: exactly the twin's")
                        got = ik.int8_dynamic_dense(x, wq, scale, b)
                        want = ik.int8_dynamic_dense_reference(x, wq, scale, b)
                        torch.cuda.synchronize()
                        err = float((got.float() - want.float()).abs().max())
                        ulps = max_ulps(got, want, 24 if dtype == torch.float32 else 8)
                        worst[dname] = max(worst[dname], err)
                        check(bool(torch.isfinite(got).all()) and got.dtype == dtype and got.shape == (m, n),
                              f"int8_dynamic_dense {name} M={m} {dname} bias={b is not None}: finite, {dtype}")
                        check(ulps <= K7_MAX_ULPS,
                              f"int8_dynamic_dense {name} M={m} {dname} bias={b is not None}: "
                              f"max|d|={err:.3e}, {ulps:g} ulp <= {K7_MAX_ULPS} (target 0)")
                    if dtype == torch.bfloat16:  # the model's call: bf16 x and out, with the bias
                        w16, b16 = weight.to(dtype), bias.to(dtype)
                        bound, bound_by = int8_bound_ms(m, k, n, 2, 2, bias=True)
                        timed[(name, m)] = dict(
                            ms=median_ms(lambda: ik.int8_dynamic_dense(x, wq, scale, bias)),
                            plain_ms=median_ms(lambda: ik.int8_dynamic_dense_reference(x, wq, scale, bias)),
                            library_ms=median_ms(lambda: F.linear(x, w16, b16)),
                            bound_ms=bound, bound_by=bound_by,
                            quantize_ms=median_ms(lambda: ik._quantize_rows_kernel(x)),
                            product_ms=median_ms(lambda: ik._scaled_product_kernel(xq, row_scale, wq, scale, bias,
                                                                                   dtype)),
                        )
                        t = timed[(name, m)]
                        print(f"time int8_dynamic_dense {name} (K={k}, N={n}) M={m} bf16: kernel {t['ms']:.4f} ms "
                              f"({2 * m * k * n / t['ms'] / 1e9:.1f} TOP/s; row quantization {t['quantize_ms']:.4f} ms, "
                              f"wgmma product {t['product_ms']:.4f} ms, "
                              f"{2 * m * k * n / t['product_ms'] / 1e9:.1f} TOP/s), plain {t['plain_ms']:.4f} ms, "
                              f"bf16 F.linear {t['library_ms']:.4f} ms, bound {bound:.4f} ms by {bound_by} "
                              f"({bound / t['ms']:.1%} of bound)")
                    del x, xq, row_scale, levels, want_scale, product
            del weight, wq, scale, bias
        # the 72 launches of one B=128 forward, and the bf16 gemms they replace
        forward_ms, library_forward = (
            ENCODER_LAYERS * sum(INT8_PER_LAYER[name] * timed[(name, M_FULL)][key] for name in INT8_SHAPES)
            for key in ("ms", "library_ms")
        )
        print(f"int8_dynamic_dense: the {INT8_PER_FORWARD} launches of a B={B} forward sum to {forward_ms:.3f} ms; "
              f"the bf16 F.linear calls they replace, {library_forward:.3f} ms")

        # K8 at scripts/bench_int8_matmul.py's shape, B as [K, N]
        k, n = INT8_SHAPES["fc1"]
        xq = torch.randint(-127, 128, (M_FULL, k), device="cuda", dtype=torch.int8, generator=gen)
        wq = torch.randint(-127, 128, (k, n), device="cuda", dtype=torch.int8, generator=gen)
        got, want = ik.int8_matmul(xq, wq), ik.int8_matmul_reference(xq, wq)
        torch.cuda.synchronize()
        k8_err = float((got.double() - want.double()).abs().max())
        check(got.dtype == torch.int32 and torch.equal(got, want),
              f"int8_matmul M={M_FULL} K={k} N={n}: exactly the twin's (max|d| {k8_err:g})")
        nbytes = M_FULL * k + k * n + M_FULL * n * 4
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 2.0 * M_FULL * k * n / PEAK_INT8_OPS * 1e3
        k8 = dict(
            max_abs_err=k8_err, ms=median_ms(lambda: ik.int8_matmul(xq, wq)),
            plain_ms=median_ms(lambda: ik.int8_matmul_reference(xq, wq)),
            library_ms=median_ms(lambda: torch._int_mm(xq, wq)),
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        )
        print(f"time int8_matmul M={M_FULL} K={k} N={n}: kernel {k8['ms']:.4f} ms "
              f"({2 * M_FULL * k * n / k8['ms'] / 1e9:.1f} TOP/s), plain {k8['plain_ms']:.4f} ms, "
              f"torch._int_mm {k8['library_ms']:.4f} ms, bound {k8['bound_ms']:.4f} ms by {k8['bound_by']}")
        del xq, wq, got, want
    torch.cuda.empty_cache()
    k8_launches = read_counts()["int8_matmul"]
    print(f"int8_matmul (K8) launched {k8_launches} times in this phase")
    k7 = {key: timed[("fc1", M_FULL)][key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    k7["max_abs_err"] = max(worst.values())
    print(json.dumps({"int8_dense_ms": {f"{name} M={m}": t["ms"] for (name, m), t in timed.items()},
                      "int8_quantize_ms": {f"{name} M={m}": t["quantize_ms"] for (name, m), t in timed.items()},
                      "int8_product_ms": {f"{name} M={m}": t["product_ms"] for (name, m), t in timed.items()},
                      "bf16_linear_ms": {f"{name} M={m}": t["library_ms"] for (name, m), t in timed.items()},
                      "k7_forward_ms": forward_ms, "bf16_linear_forward_ms": library_forward,
                      "k7_max_abs_err": worst}))
    return k7, k8, k8_launches


def int8_layers_exact(model, x) -> tuple:
    """Run ``model`` on ``x`` and hold every Int8Linear's output to the K7
    twin on the same input. Returns (layers checked, worst max|d|)."""
    import torch

    from avex_tpu_torch.ops import int8_kernels as ik
    from avex_tpu_torch.quant import Int8Linear

    seen = []

    def hook(layer, inputs, output):
        want = ik.int8_dynamic_dense_reference(inputs[0], layer.weight_q, layer.weight_scale, layer.bias,
                                               out_dtype=layer.dtype)
        seen.append(float((output.float() - want.float()).abs().max()))

    handles = [m.register_forward_hook(hook) for m in model.module.modules() if isinstance(m, Int8Linear)]
    try:
        with torch.no_grad():
            model.module(x)
    finally:
        for h in handles:
            h.remove()
    return len(seen), max(seen)


def int8_levels(model, x) -> tuple:
    """Run ``model`` on ``x``; returns its pooled final features and the int8
    activation levels that each Int8Linear's input quantized to, on the host,
    in call order."""
    import torch

    from avex_tpu_torch.ops import int8_kernels as ik
    from avex_tpu_torch.quant import Int8Linear

    levels = []

    def hook(layer, inputs):
        levels.append(ik.quantize_rows(inputs[0])[0].to(torch.int8).cpu())

    handles = [m.register_forward_pre_hook(hook) for m in model.module.modules() if isinstance(m, Int8Linear)]
    try:
        with torch.no_grad():
            pooled = model.module(x)[0].mean(dim=1).float().cpu()
    finally:
        for h in handles:
            h.remove()
    return pooled, levels


def phase_int8_main_path():
    """Int8 BEATs through ``load_model(quantization="int8")``: launch counts,
    quality against the float model with the same weights and against the
    same int8 model on the CPU; returns K7's launches in the bf16 run."""
    import torch

    official = beats_config()
    layers = official["encoder_layers"]
    n_emb = (layers + 1) * official["encoder_embed_dim"]
    gen = torch.Generator(device="cuda").manual_seed(6)
    batches = [torch.randn(B, CLIP_SAMPLES, device="cuda", generator=gen) * 0.1 for _ in range(N_BATCHES)]

    def run(model, label, expect):
        return drive(model, label, expect, batches, n_emb, lambda features, aux: features.mean(dim=1))

    with torch.no_grad():
        float16 = load_beats("bfloat16", use_pallas=True)
        _, pooled_f, _, rate_f = run(float16, "int8 phase: float bf16 (same weights)", {"gated_bias_attention": layers})
        del float16
        int8 = load_beats("bfloat16", quantization="int8", use_pallas=True)
        _, pooled_q, counts, rate_q = run(int8, "main int8 bf16",
                                          {"int8_dynamic_dense": INT8_PER_FORWARD, "gated_bias_attention": layers})
        n, worst = int8_layers_exact(int8, batches[0])
        check(n == INT8_PER_FORWARD and worst == 0.0,
              f"int8 bf16 model, B={B}: each of its {n} int8 layers equals the K7 twin on its own input "
              f"(max|d| {worst:g})")
        del int8
        rel = rel_l2(pooled_q, pooled_f)
        check(rel < INT8_FLOAT_REL, f"int8 vs float bf16, same weights: pooled rel L2 {rel:.3e} < {INT8_FLOAT_REL:g}")

        # The fp32 int8 model on the card (K7, K1) and the same model moved to
        # the CPU (their plain twins), on two clips.
        int8_32 = load_beats("float32", quantization="int8", use_pallas=True)
        small = batches[0][:2]
        n, worst = int8_layers_exact(int8_32, small)
        check(n == INT8_PER_FORWARD and worst == 0.0,
              f"int8 fp32 model, B=2: each of its {n} int8 layers equals the K7 twin on its own input "
              f"(max|d| {worst:g})")
        card_pooled, card_levels = int8_levels(int8_32, small)
        card_emb = int8_32.extract_embeddings(small, aggregation="mean").float().cpu()
        int8_32.to("cpu")
        host_pooled, host_levels = int8_levels(int8_32, small.cpu())
        host_emb = int8_32.extract_embeddings(small.cpu(), aggregation="mean").float()
        del int8_32
        r1, r2 = rel_l2(card_pooled, host_pooled), rel_l2(card_emb, host_emb)
        check(r1 <= INT8_CARD_CPU_REL and r2 <= INT8_CARD_CPU_REL,
              f"int8 fp32 on the card vs the same model on the CPU (twins), B=2: pooled rel {r1:.3e}, "
              f"embeddings rel {r2:.3e} <= {INT8_CARD_CPU_REL:g}")
        # Where that gap comes from: the int8 levels the card and the CPU give
        # the same layer's input, and the float model alone, card vs CPU.
        flips = [int((a != b).sum()) for a, b in zip(card_levels, host_levels)]
        step = max(int((a.int() - b.int()).abs().max()) for a, b in zip(card_levels, host_levels))
        sizes = [a.numel() for a in card_levels]
        per = sum(INT8_PER_LAYER.values())
        per_layer = [sum(flips[i:i + per]) for i in range(0, len(flips), per)]
        del card_levels, host_levels
        float32 = load_beats("float32", use_pallas=True)
        float_card = float32.module(small)[0].mean(dim=1).float().cpu()
        float32.to("cpu")
        float_host = float32.module(small.cpu())[0].mean(dim=1).float()
        del float32
        r_float = rel_l2(float_card, float_host)
        print(f"int8 fp32, card vs CPU, B=2: {sum(flips)} of {sum(sizes)} int8 activations take another level "
              f"(largest step {step}), {flips[0]} of {sizes[0]} at the first int8 layer; per encoder layer "
              f"{per_layer}")
        check(r_float <= PATH_REL, f"float fp32 on the card vs the same model on the CPU, B=2: pooled rel "
                                   f"{r_float:.3e} <= {PATH_REL:g}")
    torch.cuda.empty_cache()
    print(f"int8 BEATs bf16: {rate_q:.1f} clips/s vs float bf16 {rate_f:.1f} clips/s (B={B}, same weights)")
    print(json.dumps({
        "model": "beats_int8",
        "clips_per_s": {"bf16_int8_kernel": rate_q, "bf16_float_kernel": rate_f},
        "int8_vs_float_pooled_rel_l2": rel, "card_vs_cpu_fp32_rel": [r1, r2],
        "card_vs_cpu_int8_flips": sum(flips), "int8_activations": sum(sizes),
        "card_vs_cpu_fp32_float_rel": r_float,
        "batch": B, "clip_seconds": CLIP_SAMPLES / 16000,
    }))
    return counts["int8_dynamic_dense"]


def phase_serving():
    """The int8 and the float bf16 BEATs in one ServicePool behind the HTTP
    server: 8 producer threads, 96 clips each model, 2 HTTP requests; every
    row against the clip extracted alone."""
    import http.client
    import io
    import threading

    import numpy as np
    import torch
    from scipy.io import wavfile

    from avex_tpu_torch._native import decode_audio_bytes, resample
    from avex_tpu_torch.ops.audio import pad_or_window_np
    from avex_tpu_torch.serving import AvexHTTPServer, ServiceConfig, ServicePool

    rng = np.random.default_rng(7)
    sr = 16000

    def clip(i):
        """Most clips are 5 s at 16 kHz; every 8th is 3 s (padded), 7 s
        (center-cropped) or 5 s at 8 kHz (resampled)."""
        kind = i % 8
        seconds, rate = {1: (3, sr), 2: (7, sr), 3: (5, 8000)}.get(kind, (5, sr))
        return (rng.standard_normal(seconds * rate) * 0.1).astype(np.float32), rate

    clips = [clip(i) for i in range(N_SERVED)]
    # The int8 model first: the pool's default, served on the bare routes.
    models = {"int8": load_beats("bfloat16", quantization="int8", use_pallas=True),
              "float": load_beats("bfloat16", use_pallas=True)}
    config = ServiceConfig(clip_seconds=CLIP_SAMPLES / sr, max_batch=32, max_wait_ms=10, layers=["all"])
    pool = ServicePool.from_models(models, config=config)
    server = AvexHTTPServer(pool, port=0, request_timeout=SERVE_TIMEOUT).start()
    try:
        start = time.perf_counter()
        pool.warmup(buckets=[1, 32], timeout=SERVE_TIMEOUT)
        print(f"serving: warm-up of buckets 1 and 32 for both models {time.perf_counter() - start:.2f} s")
        resample(clips[3][0], 8000, sr)  # the first call builds the native library
        t0 = time.perf_counter()
        resample(clips[3][0], 8000, sr)
        resample_ms = (time.perf_counter() - t0) * 1e3
        print(f"serving: host resampling of one 5 s clip from 8 kHz: {resample_ms:.2f} ms (on the submitting thread)")
        forward_ms = {}
        for name, model in models.items():  # what the batcher thread runs per batch, alone
            for bucket in (1, 32):
                clips_in, masks_in = np.zeros((bucket, CLIP_SAMPLES), np.float32), np.zeros((bucket, CLIP_SAMPLES), bool)
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    with torch.no_grad():
                        model.extract_embeddings(clips_in, padding_mask=masks_in, aggregation="mean").float().cpu()
                    times.append((time.perf_counter() - t0) * 1e3)
                forward_ms[(name, bucket)] = statistics.median(times)
            print(f"serving {name}: one bucket-1 batch {forward_ms[(name, 1)]:.2f} ms, one bucket-32 batch "
                  f"{forward_ms[(name, 32)]:.2f} ms (host clock, numpy in, rows out; median of 5)")
        rows = {name: [None] * len(clips) for name in models}
        latency = {name: [] for name in models}
        lock = threading.Lock()

        def producer(worker):
            # A contiguous share of the clips: each producer sends the mix
            # (with every 8th index a resampled clip) as a client would.
            futures = []
            share = len(clips) // N_PRODUCERS
            for i in range(worker * share, (worker + 1) * share):
                wav, rate = clips[i]
                for name in models:
                    t0 = time.perf_counter()
                    fut = pool.get(name).submit(wav, sr=rate)

                    def done(f, name=name, t0=t0):
                        with lock:
                            latency[name].append(time.perf_counter() - t0)
                    fut.add_done_callback(done)
                    futures.append((name, i, fut))
            for name, i, fut in futures:
                rows[name][i] = fut.result(timeout=SERVE_TIMEOUT)

        start = time.perf_counter()
        threads = [threading.Thread(target=producer, args=(w,)) for w in range(N_PRODUCERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SERVE_TIMEOUT)
        elapsed = time.perf_counter() - start
        check(all(r is not None for name in models for r in rows[name]),
              f"serving: every one of the {len(clips)} clips answered by both models")

        # Two requests over HTTP: a .npy body to the float model by name, a
        # WAV body to the pool's default (the int8 model) on the bare route.
        conn = http.client.HTTPConnection(server.host, server.port, timeout=SERVE_TIMEOUT)
        try:
            npy = io.BytesIO()
            np.save(npy, clips[0][0])
            conn.request("POST", "/models/float/embed", body=npy.getvalue())
            http_npy = np.asarray(json.loads(conn.getresponse().read())["output"], np.float32)
            wav_body = io.BytesIO()
            wavfile.write(wav_body, sr, (clips[4][0] * 32767).clip(-32768, 32767).astype(np.int16))
            conn.request("POST", "/embed", body=wav_body.getvalue())
            http_wav = np.asarray(json.loads(conn.getresponse().read())["output"], np.float32)
        finally:
            conn.close()

        def direct(model, wav, rate):
            if rate != sr:
                wav = resample(wav, rate, sr)
            prepared, mask = pad_or_window_np(wav, CLIP_SAMPLES, window_selection="center")
            with torch.no_grad():
                out = model.extract_embeddings(prepared[None], padding_mask=mask[None], aggregation="mean")
            return out[0].float().cpu().numpy()

        def rel(a, b):
            return float(np.linalg.norm(a - b) / np.linalg.norm(b))

        for name, model in models.items():
            worst = max(rel(rows[name][i], direct(model, *clips[i])) for i in range(len(clips)))
            check(worst <= SERVE_REL, f"serving {name}: every row vs its clip extracted alone: "
                                      f"worst rel {worst:.3e} <= {SERVE_REL:g}")
        decoded, _ = decode_audio_bytes(wav_body.getvalue())
        r_npy = rel(http_npy, direct(models["float"], clips[0][0], sr))
        r_wav = rel(http_wav, direct(models["int8"], decoded, sr))
        check(r_npy <= SERVE_REL and r_wav <= SERVE_REL,
              f"serving over HTTP: .npy to /models/float rel {r_npy:.3e}, WAV to the default (int8) rel "
              f"{r_wav:.3e} <= {SERVE_REL:g}")
        summary = {}
        for name in models:
            stats = pool.get(name).info()["stats"]
            buckets = stats["bucket_counts"]
            check(all(b & (b - 1) == 0 for b in buckets), f"serving {name}: buckets {sorted(buckets)} powers of two")
            lat = np.asarray(latency[name]) * 1e3
            summary[name] = {"requests_per_s": len(clips) / elapsed, "p50_ms": float(np.percentile(lat, 50)),
                             "p99_ms": float(np.percentile(lat, 99)), "bucket_counts": buckets,
                             "batches": stats["batches"], "padded_rows": stats["padded_rows"],
                             "bucket1_batch_ms": forward_ms[(name, 1)], "bucket32_batch_ms": forward_ms[(name, 32)]}
            print(f"serving {name}: {len(clips)} requests in {elapsed * 1e3:.1f} ms alongside the other model "
                  f"({summary[name]['requests_per_s']:.1f} requests/s), latency p50 {summary[name]['p50_ms']:.1f} ms, "
                  f"p99 {summary[name]['p99_ms']:.1f} ms; buckets {buckets}")
        print(json.dumps({"serving": summary, "producers": N_PRODUCERS, "clips": len(clips),
                          "resample_ms": resample_ms}))
    finally:
        server.stop()
        pool.close()
        del models
        torch.cuda.empty_cache()


def tone_batches(n_clips: int, samples: int, seed: int) -> list:
    """``n_clips`` clips on the card in batches of B_PROBE: class c is a tone
    near 250 + 700·c Hz (±3%, random phase, a slow amplitude swell) over
    white noise at a quarter of its level."""
    import math

    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    labels = torch.randperm(n_clips, generator=gen, device="cuda") % PROBE_CLASSES
    t = torch.arange(samples, device="cuda") / 16000.0
    freq = (250.0 + 700.0 * labels) * (1.0 + 0.03 * (2 * torch.rand(n_clips, generator=gen, device="cuda") - 1))
    phase = 2 * math.pi * torch.rand(n_clips, 1, generator=gen, device="cuda")
    swell = 0.6 + 0.4 * torch.sin(2 * math.pi * 0.5 * t)[None] * torch.rand(n_clips, 1, generator=gen, device="cuda")
    wav = 0.1 * swell * torch.sin(2 * math.pi * freq[:, None] * t[None] + phase)
    wav = wav + 0.025 * torch.randn(n_clips, samples, generator=gen, device="cuda")
    return [{"raw_wav": wav[i:i + B_PROBE], "label": labels[i:i + B_PROBE]} for i in range(0, n_clips, B_PROBE)]


def probe_run(label, run, expect, forwards):
    """Counts reset just before ``run()`` and read just after; each kernel
    must launch ``expect[kernel]`` times per forward (``forwards``: forward
    count, backward count) and every other kernel 0 times."""
    import torch

    reset_counts()
    start = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    counts = read_counts()
    for kname in counts:
        per, n = expect.get(kname, 0), forwards[1] if kname.endswith("_backward") else forwards[0]
        check(counts[kname] == per * n, f"{label}: {kname} launched {counts[kname]} times == {per * n} "
                                        f"({per} x {n})")
    return out, counts, elapsed


def fine_tune(config, params, train, test, mode, val=None, **probe_kwargs):
    """Build a probe, train it with ``FineTuneTrainer`` and score it on
    ``test`` (``train_and_eval_offline``/``_online``'s steps); returns
    (test metrics, the epochs' history)."""
    from avex_tpu_torch.evaluation import FineTuneTrainer
    from avex_tpu_torch.probes import build_probe_from_config

    probe = build_probe_from_config(config, num_classes=PROBE_CLASSES, **probe_kwargs)
    trainer = FineTuneTrainer(probe, params, mode=mode)
    history = trainer.train(train, val)["history"]
    return trainer.evaluate(test), history, probe


def falls(label, history) -> None:
    losses = [r["train_loss"] for r in history]
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"{label}: training loss falls over {len(losses)} epochs: " + " -> ".join(f"{x:.4f}" for x in losses))


def phase_probes():
    """Probes and the evaluation library at full width: EAT with linear and
    MLP probes (offline on extracted embeddings, and online frozen), BEATs
    with attention and transformer probes (frozen and unfrozen) and
    retrieval. Returns the launches of every kernel in the phase's runs."""
    import numpy as np
    import torch

    import avex_tpu_torch
    from avex_tpu_torch.configs import PROBE_CONFIGS, TrainingParams
    from avex_tpu_torch.evaluation import compute_embeddings, eval_retrieval, eval_retrieval_cross_set
    from avex_tpu_torch.evaluation.retrieval import cosine_similarity
    from avex_tpu_torch.probes import build_probe_from_config

    total = {}
    report = {"card": CARD[0], "clips": PROBE_CLIPS, "classes": PROBE_CLASSES, "batch": B_PROBE}
    params = TrainingParams(train_epochs=PROBE_EPOCHS, lr=1e-3, batch_size=B_PROBE)
    offline_params = TrainingParams(train_epochs=OFFLINE_EPOCHS, lr=1e-3, batch_size=B_PROBE)

    def add(counts):
        for kname, n in counts.items():
            total[kname] = total.get(kname, 0) + n

    # --- EAT (12 blocks, 768-d, 10 s clips): extraction, then offline and online probes
    eat = avex_tpu_torch.load_model("esp_aves2_sl_eat_all_ssl_all", random_weights=True, return_features_only=True,
                                    device="cuda", use_pallas=True, compute_dtype="bfloat16")
    batches = tone_batches(PROBE_CLIPS, EAT_CLIP_SAMPLES, seed=21)
    n_batches = len(batches)
    (embs, labels), counts, elapsed = probe_run(
        "EAT extraction loop", lambda: compute_embeddings(eat, batches, aggregation="mean", layers=["last_layer"]),
        {"fused_qkv_attention": 12}, (n_batches, 0))
    add(counts)
    embs = embs[0]
    check(embs.shape == (PROBE_CLIPS, E) and bool(np.isfinite(embs).all()),
          f"EAT extraction loop: embeddings {embs.shape} finite")
    report["eat_extraction_clips_per_s"] = PROBE_CLIPS / elapsed
    print(f"EAT extraction loop (bf16, K5): {PROBE_CLIPS / elapsed:.1f} clips/s, {n_batches} batches of {B_PROBE} "
          f"10 s clips, host copy overlapped; {CARD[0]}")

    def offline(rows):
        return [{"embeddings_0": embs[i:i + B_PROBE], "label": labels[i:i + B_PROBE]} for i in rows]

    n_train = PROBE_CLIPS - 2 * B_PROBE
    train, val, test = (offline(range(0, n_train, B_PROBE)), offline([n_train]), offline([n_train + B_PROBE]))
    for preset in ("linear", "mlp"):
        (metrics, result, _), counts, _ = probe_run(
            f"EAT offline {preset} probe",
            lambda: fine_tune(PROBE_CONFIGS[preset], offline_params, train, test, "offline", val=val,
                              input_dim=(E,), device="cuda"),
            {}, (0, 0))  # the probe alone: no backbone kernel
        falls(f"EAT offline {preset} probe", result)
        check(all(map(math.isfinite, metrics.values())), f"EAT offline {preset} probe: test metrics {metrics} finite")
        ms = result[-1]["train_seconds"] / len(train) * 1e3
        report[f"eat_offline_{preset}_ms_per_step"] = ms
        print(f"EAT offline {preset} probe: {ms:.3f} ms per step (B={B_PROBE}, 768-d), test accuracy "
              f"{metrics['accuracy']:.3f}; {CARD[0]}")

    before = {k: v.clone() for k, v in eat.state_dict().items()}
    train_audio, test_audio = batches[:n_batches - 2], batches[n_batches - 2:]
    steps = len(train_audio) * PROBE_EPOCHS
    (metrics, result, _), counts, _ = probe_run(
        "EAT online frozen linear probe",
        lambda: fine_tune(PROBE_CONFIGS["linear"].replace(target_length=EAT_CLIP_SAMPLES), params, train_audio,
                          test_audio, "online", base_model=eat),
        {"fused_qkv_attention": 12}, (1 + steps + len(test_audio), 0))  # embedding_shapes, steps, test
    add(counts)
    falls("EAT online frozen linear probe", result)
    check(all(torch.equal(v, before[k]) for k, v in eat.state_dict().items()),
          "EAT online frozen linear probe: the backbone's parameters are bit-identical after training")
    ms = result[-1]["train_seconds"] / len(train_audio) * 1e3
    report["eat_online_frozen_linear_ms_per_step"] = ms
    print(f"EAT online frozen linear probe: {ms:.1f} ms per step (B={B_PROBE}, 10 s clips), "
          f"{B_PROBE / ms * 1e3:.1f} clips/s; {CARD[0]}")
    del eat, before, batches, train_audio, test_audio
    torch.cuda.empty_cache()

    # --- BEATs (official config, 5 s clips): attention and transformer probes over four layers
    batches = tone_batches(5 * B_PROBE, CLIP_SAMPLES, seed=22)
    train_audio, test_audio = batches[:4], batches[4:]
    steps = len(train_audio) * PROBE_EPOCHS
    model = load_beats("bfloat16", use_pallas=True)
    for preset in ("attention", "transformer"):
        config = PROBE_CONFIGS[preset].replace(target_layers=PROBE_LAYERS, target_length=CLIP_SAMPLES)
        (metrics, result, probe), counts, _ = probe_run(
            f"BEATs online frozen {preset} probe",
            lambda: fine_tune(config, params, train_audio, test_audio, "online", base_model=model),
            {"gated_bias_attention": 12}, (1 + steps + len(test_audio), 0))
        add(counts)
        check(probe.plan.input_shapes == ((T, E),) * 4 and probe.module.layer_weights is not None,
              f"BEATs {preset} probe: four [{T}, {E}] layers mixed by learned weights "
              f"({probe.plan.input_shapes})")
        falls(f"BEATs online frozen {preset} probe", result)
        ms = result[-1]["train_seconds"] / len(train_audio) * 1e3
        report[f"beats_online_frozen_{preset}_ms_per_step"] = ms
        report[f"beats_online_frozen_{preset}_clips_per_s"] = B_PROBE / ms * 1e3
        print(f"BEATs online frozen {preset} probe: {ms:.1f} ms per step, {B_PROBE / ms * 1e3:.1f} clips/s "
              f"(B={B_PROBE}, 5 s clips, 4 layers); {CARD[0]}")
        del probe

    # retrieval over the pooled last layer: same-set and train → test
    (pooled, pooled_labels), counts, _ = probe_run(
        "BEATs extraction loop for retrieval",
        lambda: compute_embeddings(model, batches, aggregation="mean", layers=["last_layer"]),
        {"gated_bias_attention": 12}, (len(batches), 0))
    add(counts)
    del model
    torch.cuda.empty_cache()
    pooled = pooled[0]  # numpy, as the extraction loop returns it: retrieval puts it on the card
    query, db = pooled[:4 * B_PROBE], pooled[4 * B_PROBE:]
    ref = pooled.astype(np.float64)
    ref = ref / np.maximum(np.linalg.norm(ref, axis=1, keepdims=True), 1e-12)
    for what, a, b, want in (("same-set", pooled, pooled, ref @ ref.T),
                             ("cross-set", query, db, ref[:4 * B_PROBE] @ ref[4 * B_PROBE:].T)):
        sim = cosine_similarity(a, b)
        check(sim.is_cuda, f"retrieval {what}: the similarity matrix of numpy input is on {sim.device}")
        sim = sim.double().cpu().numpy()
        rel = float(np.linalg.norm(sim - want) / np.linalg.norm(want))
        check(rel <= SIM_REL, f"retrieval {what}: the card's similarity matrix {sim.shape} vs float64 CPU rel "
                              f"{rel:.3e} <= {SIM_REL:g}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    start = time.perf_counter()
    same = eval_retrieval(pooled, pooled_labels)
    retrieval_ms = (time.perf_counter() - start) * 1e3
    peak = torch.cuda.max_memory_allocated() - held
    check(peak >= 4 * len(pooled) ** 2, f"retrieval: eval_retrieval's similarity product ran on the card "
                                        f"({peak} bytes allocated there >= {4 * len(pooled) ** 2})")
    cross = eval_retrieval_cross_set(query, pooled_labels[:4 * B_PROBE], db, pooled_labels[4 * B_PROBE:])
    check(all(map(math.isfinite, [*same.values(), *cross.values()])), f"retrieval: {same}, {cross} finite")
    report.update(retrieval_ms=retrieval_ms, retrieval=same, retrieval_cross_set=cross)
    print(f"retrieval over {len(pooled)} pooled BEATs embeddings: {retrieval_ms:.1f} ms (numpy input, similarity "
          f"on the card, ROC-AUC and precision@1 on the host), {same}; {CARD[0]}")
    del pooled, query, db

    # unfrozen: the backbone trains with the probe through K2 and K3
    fused = load_beats("bfloat16", use_pallas=True, fused_qkv=True)
    probe_param = dict(fused.module.named_parameters())["backbone.encoder.layers.5.fc1.weight"]
    start_value = probe_param.detach().clone()
    config = PROBE_CONFIGS["attention"].replace(target_layers=PROBE_LAYERS, target_length=CLIP_SAMPLES,
                                                freeze_backbone=False)
    unfrozen = TrainingParams(train_epochs=UNFROZEN_EPOCHS, lr=UNFROZEN_LR, batch_size=B_PROBE)
    (metrics, result, _), counts, _ = probe_run(
        "BEATs online unfrozen attention probe (fused_qkv)",
        lambda: fine_tune(config, unfrozen, train_audio[:1], test_audio, "online", base_model=fused),
        {"fused_qkv_gated_attention": 12, "fused_qkv_gated_attention_backward": 12},
        (1 + UNFROZEN_EPOCHS + len(test_audio), UNFROZEN_EPOCHS))
    add(counts)
    falls("BEATs online unfrozen attention probe", result)
    check(not torch.equal(probe_param, start_value), "BEATs unfrozen probe: the backbone's parameters changed")
    ms = result[-1]["train_seconds"] * 1e3
    report["beats_online_unfrozen_attention_ms_per_step"] = ms
    print(f"BEATs online unfrozen attention probe (fused_qkv, K2 + K3): {ms:.1f} ms per step (B={B_PROBE}); "
          f"{CARD[0]}")
    del fused
    torch.cuda.empty_cache()
    # the same run on the plain path, same weights: the losses track each other
    plain = load_beats("bfloat16", use_pallas=False, fused_qkv=True)
    (_, plain_result, _), _, _ = probe_run(
        "BEATs online unfrozen attention probe, plain path",
        lambda: fine_tune(config, unfrozen, train_audio[:1], test_audio, "online", base_model=plain), {}, (0, 0))
    rel = max(abs(a["train_loss"] - b["train_loss"]) / abs(b["train_loss"]) for a, b in zip(result, plain_result))
    check(rel <= UNFROZEN_LOSS_REL, f"BEATs unfrozen probe: each epoch's loss, kernel path vs plain path, rel "
                                    f"{rel:.3e} <= {UNFROZEN_LOSS_REL:g} ("
                                    + " ".join(f"{r['train_loss']:.4f}" for r in plain_result) + " plain)")
    report["unfrozen_probe_loss_rel"] = rel
    del plain
    torch.cuda.empty_cache()

    # fp32: probe logits of the kernel path against the plain path, same weights
    wav = batches[0]["raw_wav"][:B_PROBE_CHECK]
    logits = {}
    for use_pallas in (True, False):
        model = load_beats("float32", use_pallas=use_pallas)
        config = PROBE_CONFIGS["attention"].replace(target_layers=PROBE_LAYERS, target_length=CLIP_SAMPLES)
        probe = build_probe_from_config(config, num_classes=PROBE_CLASSES, base_model=model)
        with torch.no_grad():
            logits[use_pallas] = probe(wav).float()
        del model, probe
    rel = rel_l2(logits[True], logits[False])
    check(rel <= PATH_REL,
          f"BEATs fp32 attention probe: kernel path vs plain path logits rel {rel:.3e} <= {PATH_REL:g}")
    report["fp32_probe_logits_rel"] = rel
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "probes", **report}))
    return total


def write_tone_wavs(root: Path, n_clips: int, seed: int) -> None:
    """``n_clips`` 16-bit WAVs and a metadata.csv under ``root`` (stdlib
    ``wave``): class c is a tone near 250 + 700·c Hz over noise; one clip in 8
    is at 44.1 kHz and one in 8 is 3 s long, the rest 6 s at 16 kHz."""
    import csv
    import wave

    import numpy as np

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    rows = []
    for i in range(n_clips):
        label = int(rng.integers(ENTRY_CLASSES))
        sr = 44100 if i % 8 == 3 else 16000
        seconds = ENTRY_SHORT_S if i % 8 == 5 else ENTRY_LONG_S
        t = np.arange(int(seconds * sr)) / sr
        freq = (250.0 + 700.0 * label) * (1.0 + 0.03 * rng.uniform(-1, 1))
        wav = 0.1 * np.sin(2 * np.pi * freq * t + rng.uniform(0, 2 * np.pi)) + 0.025 * rng.standard_normal(t.size)
        with wave.open(str(root / f"clip{i}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(sr)
            f.writeframes(np.round(wav * 32767).astype("<i2").tobytes())
        rows.append({"path": f"clip{i}.wav", "label": f"tone_{label}"})
    with open(root / "metadata.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["path", "label"])
        writer.writeheader()
        writer.writerows(rows)


def write_noise_wavs(root: Path, n: int = 4) -> None:
    import wave

    import numpy as np

    rng = np.random.default_rng(99)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        with wave.open(str(root / f"noise{i}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes(np.round(0.1 * rng.standard_normal(16000 * (4 + i)) * 32767).astype("<i2").tobytes())


def entry_model_spec(**init) -> dict:
    """The official BEATs config (12 x 768, 12 heads) with 5 s clips, bf16."""
    return {"name": "beats", "pretrained": False, "compute_dtype": "bfloat16",
            "init_config": dict(beats_config(), use_pallas=True, **init),
            "audio_config": {"representation": "raw", "normalize": False, "target_length_seconds": 5,
                             "window_selection": "random"}}


def busy_share(run) -> tuple:
    """(wall ms, device busy share) of ``run()`` under ``torch.profiler``:
    the union of the kernels' intervals over the span from the first
    kernel's start to the last one's end, as scripts/torch_beats_profile.py."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return wall_ms, float("nan")
    busy, reach = 0, spans[0][0]
    for lo, hi in spans:
        busy += max(0, hi - max(lo, reach))
        reach = max(reach, hi)
    return wall_ms, busy / (spans[-1][1] - spans[0][0])


def phase_entry_points(workdir: Path):
    """``run_train.main`` and ``run_evaluate.main`` at full BEATs width from
    ``kind: local`` WAV datasets, through the loader's worker processes.
    Returns the launches of every kernel in the two runs."""
    import numpy as np
    import torch

    import avex_tpu_torch.evaluation.finetune as finetune
    import avex_tpu_torch.run_evaluate as run_evaluate
    import avex_tpu_torch.run_train as run_train
    from avex_tpu_torch.configs import EvaluateConfig, RunConfig
    from avex_tpu_torch.data import Collater, DataLoader, dataset_from_config
    from avex_tpu_torch.training import Trainer

    start = time.perf_counter()
    data = workdir / "data"
    write_tone_wavs(data / "train", ENTRY_TRAIN, seed=31)
    write_tone_wavs(data / "val", ENTRY_VAL, seed=32)
    write_noise_wavs(data / "noise")
    for j, (split, n) in enumerate(zip(("train", "val", "test"), ENTRY_EVAL_SET)):
        write_tone_wavs(data / "set0" / split, n, seed=ENTRY_EVAL_SEED + j)
    print(f"entry points: {ENTRY_TRAIN + ENTRY_VAL + sum(ENTRY_EVAL_SET)} WAVs written in "
          f"{time.perf_counter() - start:.1f} s")
    layers = beats_config()["encoder_layers"]
    total, report = {}, {"card": CARD[0], "batch": B_TRAIN, "num_workers": ENTRY_WORKERS}

    # --- run_train: fused_qkv BEATs, noise and mixup, 2 epochs, a checkpoint each
    def local(name, split):
        return {"name": f"{name}_{split}", "kind": "local", "path": str(data / name / split) if split else
                str(data / name)}

    config = RunConfig.from_dict({
        "model_spec": entry_model_spec(fused_qkv=True),
        "training_params": {"train_epochs": ENTRY_EPOCHS, "lr": ENTRY_LR, "batch_size": B_TRAIN,
                            "optimizer": "adamw", "weight_decay": 0.01},
        "dataset_config": {"train_datasets": [local("train", None)], "val_datasets": [local("val", None)]},
        "augmentations": [{"noise": {"noise_dirs": [str(data / "noise")], "snr_db_range": [5, 20],
                                     "augmentation_prob": 0.5}},
                          {"mixup": {"alpha": 0.4, "augmentation_prob": 0.5}}],
        "output_dir": str(workdir / "run_train"), "checkpoint_freq": 1, "logging": "none",
        "num_workers": ENTRY_WORKERS, "device": "cuda", "seed": 0,
    })
    loaders = []
    build_dataloaders = run_train.build_dataloaders

    def capture(cfg):  # keep the loaders to read their wait counters
        out = build_dataloaders(cfg)
        loaders.append(out)
        return out

    run_train.build_dataloaders = capture
    built = []
    build_model = run_train.build_model_from_spec
    run_train.build_model_from_spec = lambda *a, **k: built.append(build_model(*a, **k)) or built[-1]
    try:
        reset_counts()
        start = time.perf_counter()
        result = run_train.main(config)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        counts = read_counts()
    finally:
        run_train.build_dataloaders, run_train.build_model_from_spec = build_dataloaders, build_model
    train_loader, val_loader = loaders[0][:2]
    steps, val_batches = len(train_loader), len(val_loader)
    expect = {"fused_qkv_gated_attention": layers * ENTRY_EPOCHS * (steps + val_batches),
              "fused_qkv_gated_attention_backward": layers * ENTRY_EPOCHS * steps}
    for kname, n in counts.items():
        check(n == expect.get(kname, 0), f"run_train: {kname} launched {n} times == {expect.get(kname, 0)} "
                                         f"({layers} a forward; {ENTRY_EPOCHS} epochs of {steps} steps and "
                                         f"{val_batches} validation batches)")
        total[kname] = total.get(kname, 0) + n
    history = result["history"]
    losses = [h["train"]["loss"] for h in history]
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          "run_train: the training loss falls over the run: " + " -> ".join(f"{x:.4f}" for x in losses))
    out = Path(config.output_dir)
    lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    check(len(lines) == 1 + ENTRY_EPOCHS and all((out / f"checkpoint_epoch_{e}").exists()
                                                 for e in range(ENTRY_EPOCHS))
          and (out / "final_model").exists() and (out / "label_map.json").exists(),
          f"run_train: metrics.jsonl ({len(lines)} lines), {ENTRY_EPOCHS} epoch checkpoints, the final model "
          f"and the label map written")
    check(train_loader.pin_memory and train_loader.batches_served == ENTRY_EPOCHS * steps,
          f"run_train: {train_loader.batches_served} pinned batches through {ENTRY_WORKERS} worker processes")
    epoch_s = history[-1]["train"]["epoch_seconds"]
    report["run_train"] = {
        "seconds": elapsed, "losses": losses, "steps_per_s": steps / epoch_s, "ms_per_step": epoch_s / steps * 1e3,
        "loader_wait_ms_per_batch": train_loader.wait_seconds / train_loader.batches_served * 1e3,
    }
    # one more epoch through the same loader and workers, profiled
    model = built[0]
    trainer = Trainer(model, config, train_loader)
    wait0, served0 = train_loader.wait_seconds, train_loader.batches_served
    train_loader.set_epoch(ENTRY_EPOCHS)
    wall_ms, busy = busy_share(lambda: trainer._run_epoch(train_loader, train=True, epoch=ENTRY_EPOCHS))
    report["run_train"].update(profiled_epoch_ms_per_step=wall_ms / steps, device_busy=busy,
                               profiled_wait_ms_per_batch=(train_loader.wait_seconds - wait0)
                               / (train_loader.batches_served - served0) * 1e3)
    # the loader's host work for one batch in this process: decode, resample, crop, augment, collate, pin
    train_ds = dataset_from_config(config.dataset_config.train_datasets[0])
    collater = Collater(target_len=5 * 16000, num_classes=ENTRY_CLASSES, augmentations=config.augmentations,
                        seed=0)
    inline = DataLoader(train_ds, B_TRAIN, collater, seed=0, pin_memory=True)
    t0 = time.perf_counter()
    n_inline = sum(1 for _ in inline)
    report["run_train"]["host_ms_per_batch_one_process"] = (time.perf_counter() - t0) / n_inline * 1e3
    # its parts: one 6 s clip decoded at 16 kHz, one at 44.1 kHz resampled, one batch collated
    from avex_tpu_torch._native import decode_audio, resample

    t0 = time.perf_counter()
    decode_audio(str(data / "train" / "clip0.wav"))
    t1 = time.perf_counter()
    wav, sr = decode_audio(str(data / "train" / "clip3.wav"))  # one clip in 8 (i % 8 == 3) is at 44.1 kHz
    t2 = time.perf_counter()
    resample(wav, sr, 16000)
    t3 = time.perf_counter()
    items = [train_ds[i] for i in range(B_TRAIN)]
    t4 = time.perf_counter()
    collater(items, rng=np.random.default_rng(0))
    report["run_train"]["host_ms"] = {"decode_16k": (t1 - t0) * 1e3, "decode_44k": (t2 - t1) * 1e3,
                                      "resample_44k": (t3 - t2) * 1e3, "collate_batch": (time.perf_counter() - t4) * 1e3}
    r = report["run_train"]
    print(f"run_train (BEATs fused_qkv, bf16, B={B_TRAIN}, {ENTRY_WORKERS} workers): {r['steps_per_s']:.3f} steps/s "
          f"({r['ms_per_step']:.1f} ms a step, second epoch), the step waited {r['loader_wait_ms_per_batch']:.2f} ms "
          f"a batch for the loader; one process takes {r['host_ms_per_batch_one_process']:.1f} ms a batch "
          f"(decode, resample, crop, noise, mixup, collate, pin: {r['host_ms']}); profiled epoch "
          f"{r['profiled_epoch_ms_per_step']:.1f} "
          f"ms a step, device busy {busy:.1%} (an in-memory batch: 74.8%, PERF.md §5); {CARD[0]}")
    del trainer, model, built, loaders, train_loader, val_loader
    torch.cuda.empty_cache()

    # --- run_evaluate: a frozen online attention probe over four layers, one set
    sets = [{"name": "tones0", "metrics": ["accuracy", "balanced_accuracy"],
             **{split: local("set0", split) for split in ("train", "val", "test")}}]
    probe = {"probe_type": "attention", "aggregation": "none", "input_processing": "sequence", "num_heads": 8,
             "num_layers": 2, "target_layers": PROBE_LAYERS, "online_training": True, "freeze_backbone": True,
             "target_length": CLIP_SAMPLES}
    eval_config = EvaluateConfig.from_dict({
        "experiments": [{"run_name": "beats_attention", "pretrained": False, "probe_config": probe,
                         "run_config": {"model_spec": entry_model_spec(),
                                        "training_params": {"train_epochs": 1, "lr": 1e-3, "batch_size": B_PROBE},
                                        "output_dir": str(workdir / "unused")}}],
        "dataset_config": {"name": "tones", "evaluation_sets": sets},
        "save_dir": str(workdir / "run_evaluate"), "device": "cuda", "seed": 0, "num_workers": ENTRY_WORKERS,
        "training_params": {"train_epochs": ENTRY_EPOCHS, "lr": ENTRY_PROBE_LR, "batch_size": B_PROBE},
        "eval_modes": ["probe"],
    })
    histories, builds = [], []
    train = finetune.FineTuneTrainer.train
    build_model = run_evaluate.build_model_from_spec

    def recording(self, *a, **k):
        result = train(self, *a, **k)
        histories.append(result["history"])
        return result

    finetune.FineTuneTrainer.train = recording
    run_evaluate.build_model_from_spec = lambda *a, **k: builds.append(1) or build_model(*a, **k)
    try:
        reset_counts()
        start = time.perf_counter()
        results = run_evaluate.main(eval_config)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        counts = read_counts()
    finally:
        finetune.FineTuneTrainer.train, run_evaluate.build_model_from_spec = train, build_model
    # backbone forwards: embedding_shapes, the training steps, validation and test batches
    tr, va, te = ENTRY_EVAL_SET
    forwards = 1 + ENTRY_EPOCHS * (-(-tr // B_PROBE) + -(-va // B_PROBE)) + -(-te // B_PROBE)
    for kname, n in counts.items():
        want = layers * forwards if kname == "gated_bias_attention" else 0
        check(n == want, f"run_evaluate: {kname} launched {n} times == {want} ({layers} a forward x {forwards})")
        total[kname] = total.get(kname, 0) + n
    check(len(builds) == 1, f"run_evaluate: the frozen backbone built {len(builds)} time(s) for one evaluation set")
    for s, history in enumerate(histories):
        falls(f"run_evaluate set {s} online frozen attention probe", history)
    save = Path(eval_config.save_dir)
    records = [json.loads(x) for x in (save / "evaluation_metadata.jsonl").read_text().splitlines()]
    check(len(records) == 1 and len(histories) == 1 and (save / "summary.csv").exists()
          and (save / "summary_simple.csv").exists()
          and all(math.isfinite(r["metrics"]["probe"]["test_accuracy"]) for r in records),
          f"run_evaluate: {len(records)} records in evaluation_metadata.jsonl and the summary CSVs written")
    ms = [h[-1]["train_seconds"] / -(-tr // B_PROBE) * 1e3 for h in histories]
    report["run_evaluate"] = {"seconds": elapsed, "probe_ms_per_step": ms, "steps_per_s": [1e3 / x for x in ms],
                              "probe_info": records[0]["probe_info"],
                              "test_accuracy": [r["metrics"]["probe"]["test_accuracy"] for r in records]}
    print(f"run_evaluate (BEATs frozen, K1, attention probe over 4 layers, B={B_PROBE}, {ENTRY_WORKERS} workers): "
          + ", ".join(f"set {s}: {x:.1f} ms a probe step ({1e3 / x:.2f} steps/s)" for s, x in enumerate(ms))
          + f"; {elapsed:.1f} s in all; {CARD[0]}")
    print(json.dumps({"phase": "entry_points", **report}))
    return total


def phase_k3_long():
    """The fp32 K3 past T=512 on the 3xTF32 kernels (which take any T and
    any width), after the 3xTF32 forward on 16-byte and on narrow rows: at
    T=520 and T=800 (B=4) with the gate,
    with the gate and a padding mask, and with neither, dqkv, dbias and
    dgate against the twin at atol/rtol 1e-4 and (3xTF32) relative L2
    TF32X3_REL_L2; the same values on narrow rows (a row stride of 3E + 1
    floats) with the gate, with and without the mask: the forward on the
    3xTF32 kernel's narrow rows (its row log-sum-exp saved), the backward on
    the 3xTF32 kernels, at the same bounds; then times the gated call at T=800 against the twin,
    the fp32 SDPA backward and its bound. Returns the T=800 numbers for the
    JSON line."""
    import torch

    from avex_tpu_torch.ops import attention_kernels as ak

    gen = torch.Generator(device="cuda").manual_seed(21)
    result = {}
    for seq in (T_K3_FP32, T_LONG):
        qkv = torch.randn(B_LONG, seq, 3 * E, device="cuda", generator=gen).requires_grad_()
        bias = torch.randn(H, seq, seq, device="cuda", generator=gen).requires_grad_()
        gate = (torch.rand(B_LONG, H, seq, device="cuda", generator=gen) + 1.0).requires_grad_()
        dout = torch.randn(B_LONG, seq, E, device="cuda", generator=gen)
        mask = torch.zeros(B_LONG, seq, dtype=torch.bool, device="cuda")
        mask[1::2, seq * 2 // 3:] = True
        # the same values on narrow rows: the narrow 3xTF32 forward saves its LSE, the 3xTF32 K3 runs from it
        store = torch.zeros(B_LONG, seq, 3 * E + 1, device="cuda", requires_grad=True)
        with torch.no_grad():
            store[..., 1:].copy_(qkv)
        narrow = store[..., 1:]
        worst = 0.0
        cases = [(qkv, gate, None, "16-byte rows"), (qkv, gate, mask, "16-byte rows"), (qkv, None, None, "16-byte rows"),
                 (narrow, gate, None, "narrow rows"), (narrow, gate, mask, "narrow rows")]
        for x, g, m, rows in cases:
            inputs = (x, bias) if g is None else (x, bias, g)
            reset_counts()
            out, forward_bodies = bodies_of(lambda: ak.fused_qkv_gated_attention(x, H, bias, g, m), forward=True)
            check(forward_bodies == {"tf32x3": 1}, f"fp32 K2 T={seq} on {rows}: ran on the tf32x3 forward "
                                                   f"({forward_bodies})")
            check(out.grad_fn.saved_tensors[-1] is not None, f"fp32 K2 T={seq} on {rows}: saved its LSE")
            got, bodies = bodies_of(lambda: torch.autograd.grad(out, inputs, dout))
            launched = read_counts()["fused_qkv_gated_attention_backward"]
            want = ak.fused_qkv_gated_backward_reference(qkv.detach(), H, bias.detach(),
                                                         None if g is None else g.detach(), m, dout)
            label = f"fp32 K3 T={seq} B={B_LONG} gate={g is not None} mask={m is not None} {rows}"
            check(launched == 1 and bodies == {"tf32x3": 1},
                  f"{label}: launched the kernel once ({launched}), on the tf32x3 body ({bodies})")
            for name, a, b in zip(("dqkv", "dbias", "dgate"), got, want):
                err, rel = float((a - b).abs().max()), rel_l2(a, b)
                check(a.shape == b.shape and bool(torch.allclose(a, b, atol=K3_LONG_TOL, rtol=K3_LONG_TOL))
                      and rel <= TF32X3_REL_L2,
                      f"{label}: {name} {tuple(a.shape)} max|d| {err:.3e} within atol/rtol {K3_LONG_TOL:g}, "
                      f"rel L2 {rel:.3e} <= {TF32X3_REL_L2:g}")
                worst = max(worst, err)
            del out, got
        del store, narrow
        if seq == T_LONG:
            out = ak.fused_qkv_gated_attention(qkv, H, bias, gate)
            ms = median_ms(lambda: torch.autograd.grad(out, (qkv, bias, gate), dout, retain_graph=True))
            plain_ms = median_ms(lambda: ak.fused_qkv_gated_backward_reference(
                qkv.detach(), H, bias.detach(), gate.detach(), None, dout))
            q, k, v = (t.detach().permute(0, 2, 1, 3).requires_grad_()
                       for t in qkv.detach().view(B_LONG, seq, 3, H, D).unbind(2))
            gated_bias = (gate.detach()[..., None] * bias.detach()[None]).requires_grad_()
            library_ms = sdpa_backward_ms(q, k, v, gated_bias, dout)
            bound, bound_by = backward_bound_ms("float32", B_LONG, seq, gated=True, padded=False, tf32x3=True)
            print(f"time fused_qkv_gated_attention_backward B={B_LONG} T={seq} float32 (gate, no mask, tensor "
                  f"cores, 3xTF32): kernel {ms:.4f} ms ({tflops(10.0 * B_LONG * H * seq * seq * D, ms):.2f} "
                  f"TFLOP/s), plain {plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms, bound {bound:.4f} ms "
                  f"by {bound_by} ({bound / ms:.1%} of bound){fp32_backward_note(ms, B_LONG, seq)}; "
                  f"{CARD[0]}")
            result = dict(batch=B_LONG, seq=seq, max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound, bound_by=bound_by)
            del out, q, k, v, gated_bias
        del qkv, bias, gate, dout, mask
        torch.cuda.empty_cache()
    return result


def phase_beats_long_step():
    """One fp32 BEATs ``fused_qkv`` training step on 16 s clips (T=792, past
    the fp32 K3's shared-memory rows) at B=4: the kernel path's loss and
    gradients against the plain path's; K2 and K3 12 launches. Returns the
    kernel path's launches."""
    import torch

    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec

    layers = beats_config()["encoder_layers"]

    def load(dtype, use_pallas):
        spec = ModelSpec(name="beats", pretrained=False, compute_dtype=dtype,
                         init_config=dict(beats_config(), fused_qkv=True, use_pallas=use_pallas))
        return avex_tpu_torch.load_model(spec, random_weights=True, num_classes=N_CLASSES, device="cuda")

    gen = torch.Generator(device="cuda").manual_seed(22)
    wav = torch.randn(B_LONG, LONG_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1
    with torch.no_grad():
        tokens = load("float32", True).module(wav[:1])[1]["features"].shape[1]
    check(tokens > 512, f"BEATs on {LONG_CLIP_SAMPLES // 16000} s clips: T={tokens} tokens, past 512")
    expect = {"fused_qkv_gated_attention": layers, "fused_qkv_gated_attention_backward": layers}
    grad_check = training_gradient_check(f"BEATs {LONG_CLIP_SAMPLES // 16000} s", load, wav, expect)
    print(json.dumps({"model": "beats", "long_clip_step": {"tokens": tokens, **grad_check},
                      "batch": B_LONG, "clip_seconds": LONG_CLIP_SAMPLES / 16000}))
    return grad_check["kernel_path_launches"]


def conv_precision(dtype: str):
    """fp32 convolutions in full fp32, forward and backward (cuDNN takes
    TF32 by default); bf16 as it is."""
    import contextlib

    from avex_tpu_torch.ops._precision import full_fp32

    return full_fp32() if dtype == "float32" else contextlib.nullcontext()


def cnn_extract(model, label, batches, aggregation):
    """Reset the counts, warm-up and timed ``extract_embeddings`` over every
    tap, read the counts: a CNN launches no kernel of the port (its convs,
    BatchNorm and pooling are cuDNN's and PyTorch's, as XLA's in JAX).
    Returns (first embeddings, clips/s, peak bytes)."""
    import torch

    model.register_hooks_for_layers(["all"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    first = model.extract_embeddings(batches[0], aggregation=aggregation)
    torch.cuda.synchronize()
    start = time.perf_counter()
    outs = [model.extract_embeddings(w, aggregation=aggregation) for w in batches]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    check(not any(counts.values()), f"{label}: no kernel of the port launched ({ {k: v for k, v in counts.items() if v} })")
    for out in [first, *outs]:
        for emb in (out if isinstance(out, list) else [out]):
            check(emb.shape[0] == batches[0].shape[0] and bool(torch.isfinite(emb).all()),
                  f"{label}: embeddings {tuple(emb.shape)} finite")
    rate = batches[0].shape[0] * len(batches) / elapsed
    print(f"{label}: {rate:.1f} clips/s (B={batches[0].shape[0]}, {len(batches)} batches, {elapsed * 1e3:.1f} ms), "
          f"peak {peak / 2**30:.2f} GiB; {CARD[0]}")
    return first, rate, peak


def phase_efficientnet():
    """EfficientNet-B0 as the official ``esp_aves2_effnetb0_all`` entry builds
    it (16 kHz, n_fft 800, hop 160, 128 mels, normalised), 10 s clips (1001
    frames), B=128: all 17 taps mean-pooled through the 4-D aggregation in
    bf16 and fp32 (full fp32 convs); the fp32 model on the card against the
    same model on the CPU (2 clips)."""
    import torch

    import avex_tpu_torch

    def load(dtype, device="cuda"):
        return avex_tpu_torch.load_model(EFFNET_ENTRY, random_weights=True, return_features_only=True,
                                         device=device, compute_dtype=dtype)

    gen = torch.Generator(device="cuda").manual_seed(17)
    batches = [torch.randn(B, EFFNET_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1 for _ in range(N_BATCHES_CNN)]
    report, pooled = {}, {}
    for dtype in ("bfloat16", "float32"):
        model = load(dtype)
        check(len(model.get_model_layers()) == 17, f"EfficientNet-B0: {len(model.get_model_layers())} taps == 17")
        image = tuple(model.process_audio(batches[0][:1]).shape)
        check(image == (1, 3, 128, EFFNET_FRAMES), f"EfficientNet-B0 input image {image} == (1, 3, 128, 1001)")
        with conv_precision(dtype):
            first, rate, peak = cnn_extract(model, f"EfficientNet-B0 {dtype} extraction (17 taps, mean)", batches,
                                            "mean")
        width = model.embedding_shapes((B, EFFNET_CLIP_SAMPLES), "mean")[0]
        check(tuple(first.shape) == width, f"EfficientNet-B0 {dtype}: pooled taps {tuple(first.shape)} == {width}")
        pooled[dtype] = first.float()
        report[dtype] = {"clips_per_s": rate, "peak_bytes": peak}
        if dtype == "float32":
            cpu = load("float32", "cpu")
            cpu.register_hooks_for_layers(["all"])
            want = cpu.extract_embeddings(batches[0][:2].cpu(), aggregation="mean")
            with conv_precision(dtype):
                got = model.extract_embeddings(batches[0][:2], aggregation="mean").cpu()
            r = rel_l2(got, want)
            check(r <= CNN_CARD_CPU_REL, f"EfficientNet-B0 fp32 (full fp32 convs) card vs CPU, 2 clips: rel L2 {r:.3e} "
                                         f"<= {CNN_CARD_CPU_REL:g}")
            report["card_vs_cpu_rel"] = r
            del cpu
        del model
        torch.cuda.empty_cache()
    r = rel_l2(pooled["bfloat16"], pooled["float32"])
    print(f"EfficientNet-B0 bf16 vs fp32, 17 taps mean-pooled: rel L2 {r:.3e}")
    print(json.dumps({"model": "efficientnet_b0", "extraction": {**report, "bf16_fp32_rel": r},
                      "batch": B, "clip_seconds": EFFNET_CLIP_SAMPLES / 16000}))


def phase_efficientnet_training(workdir):
    """EfficientNet-B0 fine-tuning through ``Trainer`` (bf16, B=64, 10 s clips,
    a 50-class head, 10 timed steps): the loss falls, the BatchNorm running
    statistics move, the eval forward normalises with them; then fp32
    gradients (full fp32 convs, forward and backward) on the card against the
    CPU at B=4."""
    import torch

    import avex_tpu_torch
    from avex_tpu_torch.training.losses import cross_entropy_loss

    def load(dtype, device="cuda"):
        return avex_tpu_torch.load_model(EFFNET_ENTRY, random_weights=True, num_classes=N_CLASSES, device=device,
                                         compute_dtype=dtype)

    gen = torch.Generator(device="cuda").manual_seed(18)
    batch = {"raw_wav": torch.randn(B_TRAIN, EFFNET_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1,
             "label": torch.randint(0, N_CLASSES, (B_TRAIN,), device="cuda", generator=gen)}
    model = load("bfloat16")
    initial = {k: v.clone() for k, v in model.module.state_dict().items() if "running" in k}
    trainer, losses, ms, rate, peak, _ = train_run("efficientnet", model, batch, {}, TRAIN_STEPS, workdir)
    check(sum(losses[-3:]) / 3 < losses[0], f"EfficientNet-B0 training: the loss falls on one repeated batch "
                                           f"({losses[0]:.4f} -> mean of the last 3 {sum(losses[-3:]) / 3:.4f})")
    trained = {k: v.clone() for k, v in model.module.state_dict().items() if "running" in k}
    moved = sum(not torch.equal(initial[k], trained[k]) for k in initial)
    check(moved == len(initial), f"EfficientNet-B0 training: {moved} of {len(initial)} running statistics moved")
    model.eval()
    wav = batch["raw_wav"][:8]
    with torch.no_grad():
        out, one = model(wav).float(), model(wav[:1]).float()
        model.module.load_state_dict(initial, strict=False)
        at_init = model(wav).float()
        model.module.load_state_dict(trained, strict=False)
    r_one, r_init = rel_l2(one, out[:1]), rel_l2(at_init, out)
    check(r_one <= CNN_BATCH_REL and r_init > 3 * CNN_BATCH_REL,
          f"EfficientNet-B0 eval forward normalises with the trained running statistics: one clip alone vs in a "
          f"batch of 8 rel L2 {r_one:.3e} <= {CNN_BATCH_REL:g}; with the initial statistics rel L2 {r_init:.3e} "
          f"> {3 * CNN_BATCH_REL:g}")
    del trainer, model
    torch.cuda.empty_cache()

    grads, losses_32 = {}, {}
    wav = batch["raw_wav"][:B_CNN_GRAD]
    labels = batch["label"][:B_CNN_GRAD]
    for device in ("cuda", "cpu"):
        m = load("float32", device)
        m.module.train()
        params = dict(m.module.named_parameters())
        with conv_precision("float32"):  # the backward's convs too
            out, _ = m.train_forward(wav.to(device), None, deterministic=True)
            loss = cross_entropy_loss(out, labels.to(device))
            step = torch.autograd.grad(loss, list(params.values()))
        grads[device] = {n: g.float().cpu() for n, g in zip(params, step)}
        losses_32[device] = loss.item()
        del m, params, out
    num = sum(float((grads["cuda"][n] - g).norm() ** 2) for n, g in grads["cpu"].items())
    den = sum(float(g.norm() ** 2) for g in grads["cpu"].values())
    grad_rel = (num / den) ** 0.5
    loss_rel = abs(losses_32["cuda"] - losses_32["cpu"]) / abs(losses_32["cpu"])
    largest = max(float(g.norm()) for g in grads["cpu"].values())
    # A BatchNorm shift ahead of another train-mode BatchNorm has an exact
    # gradient of 0: its computed value is rounding noise, left out of the worst tensor.
    worst, worst_name = max((rel_l2(grads["cuda"][n], g), n) for n, g in grads["cpu"].items()
                            if float(g.norm()) > 1e-4 * largest)
    check(loss_rel <= CNN_CARD_CPU_REL and grad_rel <= CNN_CARD_CPU_REL,
          f"EfficientNet-B0 fp32 training step, card vs CPU (B={B_CNN_GRAD}): loss rel {loss_rel:.3e}, gradients "
          f"global rel L2 {grad_rel:.3e} <= {CNN_CARD_CPU_REL:g} (worst tensor {worst:.3e}, {worst_name})")
    print(json.dumps({"model": "efficientnet_b0", "training": {
        "clips_per_s": rate, "ms_per_step": ms, "peak_bytes": peak, "losses": losses,
        "fp32_card_cpu_loss_rel": loss_rel, "fp32_card_cpu_grad_rel": grad_rel, "worst_tensor_rel": worst},
        "batch": B_TRAIN, "clip_seconds": EFFNET_CLIP_SAMPLES / 16000, "num_classes": N_CLASSES}))


def phase_perch():
    """Perch (EfficientNet-B1, TF "SAME" padding, BatchNorm eps 1e-3), 5 s at
    32 kHz, B=128, bf16 and fp32 (full fp32 convs): the 10932-wide logits and
    the 1280-d embedding; ``surfperch`` resolves to ``SurfPerchModel``."""
    import torch

    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec
    from avex_tpu_torch.models.perch import SurfPerchModel

    gen = torch.Generator(device="cuda").manual_seed(19)
    batches = [torch.randn(B, PERCH_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1 for _ in range(N_BATCHES_CNN)]
    report, embeddings = {}, {}
    for dtype in ("bfloat16", "float32"):
        model = avex_tpu_torch.load_model(ModelSpec(name="perch", pretrained=False, compute_dtype=dtype),
                                          random_weights=True, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with conv_precision(dtype):
            first = model.infer(batches[0])
            torch.cuda.synchronize()
            start = time.perf_counter()
            outs = [model.infer(w) for w in batches]
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated()
        counts = read_counts()
        check(not any(counts.values()), f"Perch {dtype}: no kernel of the port launched")
        for out in [first, *outs]:
            check(tuple(out["logits"].shape) == (B, 10932) and tuple(out["embedding"].shape) == (B, 1280)
                  and bool(torch.isfinite(out["logits"]).all()) and bool(torch.isfinite(out["embedding"]).all()),
                  f"Perch {dtype}: logits {tuple(out['logits'].shape)} and embedding {tuple(out['embedding'].shape)} "
                  f"finite")
        rate = B * len(batches) / elapsed
        print(f"Perch {dtype}: {rate:.1f} clips/s (B={B}, {len(batches)} batches of 5 s at 32 kHz), peak "
              f"{peak / 2**30:.2f} GiB; {CARD[0]}")
        embeddings[dtype] = first["embedding"].float()
        report[dtype] = {"clips_per_s": rate, "peak_bytes": peak}
        del model, first, outs
        torch.cuda.empty_cache()
    r = rel_l2(embeddings["bfloat16"], embeddings["float32"])
    print(f"Perch bf16 vs fp32 embedding: rel L2 {r:.3e}")
    check(avex_tpu_torch.get_model_class("surfperch") is SurfPerchModel, "surfperch resolves to SurfPerchModel")
    print(json.dumps({"model": "perch", "extraction": {**report, "bf16_fp32_rel": r}, "batch": B,
                      "clip_seconds": PERCH_CLIP_SAMPLES / 32000}))


def phase_resnet():
    """ResNet-152 at EfficientNet's audio config (chosen: the reference has
    no ResNet audio config), 10 s clips, B=128, bf16 and fp32 (full fp32
    convs), the four
    ``backbone.layer{i}`` taps (4-D, unpooled, as in JAX); ResNet-18 and
    ResNet-50 for one batch each."""
    import torch

    import avex_tpu_torch
    from avex_tpu_torch.api.official_models import OFFICIAL_MODELS
    from avex_tpu_torch.configs import ModelSpec

    audio = dict(OFFICIAL_MODELS[EFFNET_ENTRY]["model_spec"]["audio_config"])
    gen = torch.Generator(device="cuda").manual_seed(20)
    batches = [torch.randn(B, EFFNET_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1 for _ in range(N_BATCHES_CNN)]
    report, last = {}, {}
    for name, dtype, n in (("resnet152", "bfloat16", N_BATCHES_CNN), ("resnet152", "float32", N_BATCHES_CNN),
                           ("resnet18", "bfloat16", 1), ("resnet50", "bfloat16", 1)):
        spec = ModelSpec(name=name, pretrained=False, audio_config=audio, compute_dtype=dtype)
        model = avex_tpu_torch.load_model(spec, random_weights=True, return_features_only=True, device="cuda")
        with conv_precision(dtype):
            first, rate, peak = cnn_extract(model, f"{name} {dtype} extraction (4 taps)", batches[:n], "none")
        widths = [t.shape[1] for t in first]
        expected = [64, 128, 256, 512] if name == "resnet18" else [256, 512, 1024, 2048]
        check(widths == expected, f"{name}: tap channels {widths} == {expected}")
        if name == "resnet152":
            last[dtype] = first[-1].float().mean(dim=(2, 3))
        report[f"{name}_{dtype}"] = {"clips_per_s": rate, "peak_bytes": peak, "taps": [list(t.shape) for t in first]}
        del model, first
        torch.cuda.empty_cache()
    r = rel_l2(last["bfloat16"], last["float32"])
    print(f"ResNet-152 bf16 vs fp32, the last tap mean-pooled: rel L2 {r:.3e}")
    print(json.dumps({"model": "resnet", "extraction": {**report, "resnet152_bf16_fp32_rel": r}, "batch": B,
                      "clip_seconds": EFFNET_CLIP_SAMPLES / 16000, "audio_config": EFFNET_ENTRY}))


# ---------------------------------------------------------------------------
# EAT-SSL pretraining (phases 26-27), CLIP (phase 28), BEATs remat "dots" (phase 29)
# ---------------------------------------------------------------------------


def eat_ssl_shapes() -> tuple:
    """K5/K6 at EAT-SSL's attention shapes: (label, seq, heads, width, with a
    backward). The student sees 103 of 512 patches, the decoder all 512 at
    width 384 (6 heads of 64), the teacher all 512 under no_grad."""
    return (("student", T_SSL_VISIBLE, H, E, True), ("decoder", T_SSL, H_SSL_DECODER, E_SSL_DECODER, True),
            ("teacher", T_SSL, H, E, False))


def phase_eat_ssl_kernels():
    """K5 and K6 against their twins at EAT-SSL's three shapes (B=64), bf16
    (tensor cores) and fp32 (3xTF32);
    each timed beside its twin, its bound and SDPA (its backward for K6). The teacher's K5 runs under no_grad, as in
    the model. Returns {(kernel, shape, dtype): numbers}."""
    import torch
    import torch.nn.functional as F

    from avex_tpu_torch.ops import attention_kernels as ak

    gen = torch.Generator(device="cuda").manual_seed(26)
    results = {}

    def held(label, dtype, got, want):
        err, rel = float((got.float() - want.float()).abs().max()), rel_l2(got, want)
        check(bool(torch.isfinite(got).all()), f"{label}: finite")
        if dtype == torch.float32:
            check(err <= FP32_ATOL, f"{label}: max|d|={err:.3e} <= {FP32_ATOL:g} (rel {rel:.3e})")
        else:
            check(rel <= BF16_REL_L2, f"{label}: rel L2={rel:.3e} <= {BF16_REL_L2:g} (max|d| {err:.3e})")
        return err

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        fp32 = dtype == torch.float32
        body = "tensor cores, 3xTF32" if fp32 else "tensor cores"
        for shape, seq, heads, width, backward in eat_ssl_shapes():
            qkv = torch.randn(B_TRAIN, seq, 3 * width, device="cuda", generator=gen).to(dtype)
            q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(B_TRAIN, seq, 3, heads, D).unbind(2))
            label = f"fused_qkv_attention EAT-SSL {shape} B={B_TRAIN} T={seq} H={heads} {name}"
            with torch.no_grad():
                reset_counts()
                got, bodies = bodies_of(lambda: ak.fused_qkv_attention(qkv, heads), forward=True)
                check(read_counts()["fused_qkv_attention"] == 1 and bodies == {"tf32x3" if fp32 else "bf16": 1},
                      f"{label}: one K5 launch, on the {list(bodies)} body")
                want = ak.fused_qkv_reference(qkv, heads)
                err = fp32_forward_held(label, got, want) if fp32 else held(label, dtype, got, want)
                del want
                ms = median_ms(lambda: ak.fused_qkv_attention(qkv, heads))
                plain_ms = median_ms(lambda: ak.fused_qkv_reference(qkv, heads))
                library_ms = median_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=D**-0.5))
            bound, bound_by = attention_bound_ms(name, gated=False, padded=False, seq=seq, heads=heads, bsz=B_TRAIN,
                                                 tf32x3=fp32)
            print(f"time {label} ({body}{', no grad' if not backward else ''}): kernel {ms:.4f} ms "
                  f"({tflops(4.0 * B_TRAIN * heads * seq * seq * D, ms):.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
                  f"sdpa {library_ms:.4f} ms, bound {bound:.4f} ms by {bound_by} ({bound / ms:.1%} of bound); "
                  f"{CARD[0]}")
            results[("fused_qkv_attention", shape, name)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound, bound_by=bound_by,
                batch=B_TRAIN, seq=seq, heads=heads)
            del got, q, k, v
            if backward:
                qkv.requires_grad_()
                dout = torch.randn(B_TRAIN, seq, width, device="cuda", generator=gen).to(dtype)
                out = ak.fused_qkv_attention(qkv, heads)
                (got,), bodies = bodies_of(lambda: torch.autograd.grad(out, (qkv,), dout, retain_graph=True))
                label = f"fused_qkv_attention_backward EAT-SSL {shape} B={B_TRAIN} T={seq} H={heads} {name}"
                want = ak.fused_qkv_backward_reference(qkv.detach(), heads, None, dout)
                err = held(label, dtype, got, want)
                check(bodies == {"tf32x3" if fp32 else "bf16": 1}, f"{label}: ran on the {list(bodies)} body")
                if fp32:
                    rel = rel_l2(got, want)
                    check(rel <= TF32X3_REL_L2, f"{label}: rel L2={rel:.3e} <= {TF32X3_REL_L2:g} (3xTF32)")
                del got, want
                ms = median_ms(lambda: torch.autograd.grad(out, (qkv,), dout, retain_graph=True))
                plain_ms = median_ms(lambda: ak.fused_qkv_backward_reference(qkv.detach(), heads, None, dout))
                q, k, v = (t.detach().permute(0, 2, 1, 3).requires_grad_()
                           for t in qkv.detach().view(B_TRAIN, seq, 3, heads, D).unbind(2))
                library_ms = sdpa_backward_ms(q, k, v, None, dout)
                bound, bound_by = backward_bound_ms(name, B_TRAIN, seq, gated=False, padded=False, heads=heads,
                                                    tf32x3=fp32)
                note = fp32_backward_note(ms, B_TRAIN, seq, heads) if fp32 else ""
                print(f"time {label} ({body}): kernel {ms:.4f} ms "
                      f"({tflops(10.0 * B_TRAIN * heads * seq * seq * D, ms):.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
                      f"sdpa backward {library_ms:.4f} ms, bound {bound:.4f} ms by {bound_by} "
                      f"({bound / ms:.1%} of bound){note}; {CARD[0]}")
                results[("fused_qkv_attention_backward", shape, name)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                    bound_by=bound_by, batch=B_TRAIN, seq=seq, heads=heads)
                del dout, out, q, k, v
            del qkv
            torch.cuda.empty_cache()
    return results


def load_eat_ssl(dtype, use_pallas, **eat_cfg):
    """Full-width EAT-SSL (768 x 12, decoder 384 x 4, mask ratio 0.8, the
    top 8 teacher layers) through the registry and ``build_model_from_spec``,
    seeded random weights."""
    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec
    from avex_tpu_torch.models import eat_ssl

    avex_tpu_torch.register_model_class("eat_ssl", eat_ssl.Model)
    spec = ModelSpec(name="eat_ssl", pretrained=False, compute_dtype=dtype, eat_cfg=dict(eat_cfg))
    return avex_tpu_torch.build_model_from_spec(spec, device="cuda", use_pallas=use_pallas)


def eat_ssl_gradients(use_pallas, wav, seed):
    """One fp32 EAT-SSL step's loss and every trainable gradient, the mask
    drawn from a generator seeded ``seed``; returns (loss, grads, counts)."""
    import torch

    from avex_tpu_torch.training import make_strategy

    model = load_eat_ssl("float32", use_pallas)
    model.module.train()
    params = {n: p for n, p in model.module.named_parameters() if p.requires_grad}
    reset_counts()
    loss, _ = make_strategy("self_supervised").forward_loss(
        model.train_forward, {"raw_wav": wav}, torch.Generator(device="cuda").manual_seed(seed), train=True)
    grads = torch.autograd.grad(loss, list(params.values()))
    torch.cuda.synchronize()
    counts = read_counts()
    result = loss.item(), {n: g.float() for n, g in zip(params, grads)}, counts
    del model, params, grads
    torch.cuda.empty_cache()
    return result


def phase_eat_ssl_training(workdir):
    """EAT-SSL pretraining at full width through ``Trainer``
    (``label_type="self_supervised"``): bf16, B=64, 10 s clips, K5/K6 on
    every block (28 K5 and 16 K6 a step: student 12, decoder 4, teacher 12
    without a backward), 10 timed steps; the loss falls; the teacher after
    each of 3 more steps equals decay·t + (1-decay)·s recomputed from
    snapshots; the plain path's ms a step; fp32 kernel vs plain gradients at
    B=4 with the same mask draw. Returns the kernel path's timed launches."""
    import torch

    from avex_tpu_torch.models.eat_ssl import EATSSLModule

    gen = torch.Generator(device="cuda").manual_seed(27)
    batch = {"raw_wav": torch.randn(B_TRAIN, EAT_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1}
    model = load_eat_ssl("bfloat16", True)
    module: EATSSLModule = model.module
    n = (module.target_length // 16) * 8
    n_masked = int(module.mask_ratio * n)
    check((n, n - n_masked, len(module.decoder_blocks), module.decoder_dim) == (T_SSL, T_SSL_VISIBLE, 4, E_SSL_DECODER),
          f"EAT-SSL: {n} patches, {n - n_masked} visible, decoder {len(module.decoder_blocks)} x {module.decoder_dim}")
    expect = {"fused_qkv_attention": 28, "fused_qkv_attention_backward": 16}
    trainer, losses, ms, rate, peak, counts = train_run("eat_ssl", model, batch, expect, TRAIN_STEPS, workdir,
                                                        label_type="self_supervised")
    check(sum(losses[-3:]) / 3 < losses[0], f"EAT-SSL training: the loss falls on one repeated batch "
                                           f"({losses[0]:.4f} -> mean of the last 3 {sum(losses[-3:]) / 3:.4f})")
    worst_ema = 0.0
    for _ in range(3):
        teacher = [p.detach().clone() for p in module.teacher.parameters()]
        trainer._train_step(batch)
        with torch.no_grad():
            for t_before, t_after, s_after in zip(teacher, module.teacher.parameters(), module.student.parameters()):
                want = model.ema_decay * t_before + (1.0 - model.ema_decay) * s_after
                worst_ema = max(worst_ema, float((t_after - want).abs().max()))
        del teacher
    check(worst_ema <= 1e-6, f"EAT-SSL: the teacher after each of 3 steps equals decay·t + (1-decay)·s "
                             f"(decay {model.ema_decay}) from snapshots: max|d| {worst_ema:.3e} <= 1e-6")
    del trainer, model, module
    torch.cuda.empty_cache()

    plain = load_eat_ssl("bfloat16", False)
    _, plain_losses, plain_ms, plain_rate, plain_peak, _ = train_run(
        "eat_ssl", plain, batch, {}, SSL_PLAIN_STEPS, workdir / "plain", label_type="self_supervised")
    print(f"EAT-SSL training ms a step (B={B_TRAIN}, bf16): kernel path {ms:.1f} ms (peak {peak / 2**30:.2f} GiB), "
          f"plain path {plain_ms:.1f} ms (peak {plain_peak / 2**30:.2f} GiB); {CARD[0]}")
    del plain
    torch.cuda.empty_cache()

    wav = batch["raw_wav"][:B_SSL_GRAD]
    loss_k, grads_k, counts_k = eat_ssl_gradients(True, wav, seed=5)
    loss_p, grads_p, counts_p = eat_ssl_gradients(False, wav, seed=5)
    check(all(counts_k[k] == expect.get(k, 0) for k in counts_k) and not any(counts_p.values()),
          f"EAT-SSL fp32 gradient check: kernel path launches { {k: v for k, v in counts_k.items() if v} } "
          f"== {expect}, plain path none")
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    global_rel, worst, worst_name = gradient_distance(grads_k, grads_p)
    check(loss_rel <= PATH_REL and worst <= PATH_REL,
          f"EAT-SSL: fp32 kernel path vs plain path, one step (B={B_SSL_GRAD}, the same mask draw): loss rel "
          f"{loss_rel:.3e}, worst gradient rel L2 {worst:.3e} ({worst_name}) over {len(grads_p)} tensors "
          f"<= {PATH_REL:g} (global {global_rel:.3e})")
    print(json.dumps({"model": "eat_ssl", "training": {
        "clips_per_s": rate, "ms_per_step": ms, "peak_bytes": peak, "losses": losses,
        "plain_ms_per_step": plain_ms, "plain_clips_per_s": plain_rate, "plain_peak_bytes": plain_peak,
        "ema_max_abs_err": worst_ema, "fp32_loss_rel": loss_rel, "fp32_worst_grad_rel": worst,
        "fp32_global_grad_rel": global_rel}, "batch": B_TRAIN, "clip_seconds": EAT_CLIP_SAMPLES / 16000}))
    return counts


def load_clip(dtype, device="cuda"):
    """Full-width CLIP: EfficientNet-B0 with the official
    ``esp_aves2_effnetb0_all`` audio config, RoBERTa-base, projection 512;
    seeded random weights, the offline tokenizer."""
    import avex_tpu_torch
    from avex_tpu_torch.api.official_models import OFFICIAL_MODELS
    from avex_tpu_torch.configs import ModelSpec

    audio = dict(OFFICIAL_MODELS[EFFNET_ENTRY]["model_spec"]["audio_config"])
    spec = ModelSpec(name="clip", pretrained=False, audio_config=audio, compute_dtype=dtype, projection_dim=512,
                     text_model_name="roberta-base", efficientnet_variant="b0")
    return avex_tpu_torch.build_model_from_spec(spec, device=device)


def captions(labels) -> list:
    """Synthetic captions of ``tone_batches``' classes, one a clip, no two alike."""
    species = ("warbler", "thrush", "frog", "cricket", "owl", "wren", "cicada", "gull", "loon", "katydid")
    return [f"a {species[int(c)]} calling at dawn, recording {i}" for i, c in enumerate(labels)]


def phase_clip(workdir):
    """CLIP contrastive training through ``Trainer`` (``label_type="text"``):
    bf16, B=64, 10 s tone clips of 10 classes with synthetic captions that
    name the class, tokenized on the host, 10 timed steps (the loss falls, every BatchNorm running statistic moves,
    a2t/t2a counted, no kernel of the port launched); fp32 gradients of one
    step on the card against the CPU at B=4 (full fp32 convs, the audio
    tower's BatchNorm on its running statistics); audio-only extraction
    clips/s at B=128."""
    import torch

    from avex_tpu_torch.models import clip
    from avex_tpu_torch.training.strategies import CLIPStrategy

    gen = torch.Generator(device="cuda").manual_seed(28)
    tones = tone_batches(B_TRAIN, EFFNET_CLIP_SAMPLES, seed=28)[0]  # one tone a class: the towers can pair them
    batch = {"raw_wav": tones["raw_wav"], "text_label": captions(tones["label"])}
    model = load_clip("bfloat16")
    check(isinstance(model.tokenizer, clip.SimpleTokenizer), "CLIP: the offline tokenizer (no cached tokenizer)")
    tokens = model.tokenize(batch["text_label"])
    initial = {k: v.clone() for k, v in model.module.state_dict().items() if "running" in k}
    trainer, losses, ms, rate, peak, _ = train_run("clip", model, batch, {}, TRAIN_STEPS, workdir, label_type="text",
                                                   lr=CLIP_LR)
    check(sum(losses[-3:]) / 3 < losses[0], f"CLIP training: the loss falls on one repeated batch "
                                           f"({losses[0]:.4f} -> mean of the last 3 {sum(losses[-3:]) / 3:.4f})")
    trained = {k: v for k, v in model.module.state_dict().items() if "running" in k}
    moved = sum(not torch.equal(initial[k], trained[k]) for k in initial)
    check(moved == len(initial), f"CLIP training: {moved} of {len(initial)} BatchNorm running statistics moved")
    _, metrics = trainer._train_step(batch)
    a2t, t2a = int(metrics["a2t_correct"]), int(metrics["t2a_correct"])
    check(metrics["count"] == B_TRAIN and 0 <= a2t <= B_TRAIN and 0 <= t2a <= B_TRAIN,
          f"CLIP training: a2t {a2t} and t2a {t2a} correct of {metrics['count']} counted")
    print(f"CLIP training: tokens {tuple(tokens.shape)}, {ms:.1f} ms a step, {rate:.1f} clips/s, peak "
          f"{peak / 2**30:.2f} GiB (B={B_TRAIN}, bf16); {CARD[0]}")
    del trainer
    torch.cuda.empty_cache()

    model.eval()
    model.deregister_all_hooks()
    waves = [torch.randn(B, EFFNET_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1 for _ in range(N_BATCHES_CNN)]
    reset_counts()
    first = model.extract_embeddings(waves[0])
    torch.cuda.synchronize()
    start = time.perf_counter()
    outs = [model.extract_embeddings(w) for w in waves]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    counts = read_counts()
    check(not any(counts.values()), "CLIP extraction: no kernel of the port launched")
    for out in [first, *outs]:
        norms = out.float().norm(dim=1)
        check(tuple(out.shape) == (B, 512) and bool(torch.isfinite(out).all())
              and float((norms - 1).abs().max()) < 1e-2,
              f"CLIP extraction: projected audio features {tuple(out.shape)}, finite, unit norm")
    extract_rate = B * len(waves) / elapsed
    print(f"CLIP audio-only extraction: {extract_rate:.1f} clips/s (B={B}, {len(waves)} batches of 10 s, bf16); "
          f"{CARD[0]}")
    del model, waves, first, outs
    torch.cuda.empty_cache()

    grads, losses_32 = {}, {}
    wav, texts = batch["raw_wav"][:B_CNN_GRAD], batch["text_label"][:B_CNN_GRAD]
    for device in ("cuda", "cpu"):
        m = load_clip("float32", device)
        m.eval()
        params = dict(m.module.named_parameters())
        tokens = torch.from_numpy(m.tokenize(texts)).long()
        with conv_precision("float32"):
            loss, _ = CLIPStrategy().forward_loss(
                m.train_forward, {"raw_wav": wav.to(device), "text_tokens": tokens.to(device)}, None, train=False)
            step = torch.autograd.grad(loss, list(params.values()))
        grads[device] = {n: g.float().cpu() for n, g in zip(params, step)}
        losses_32[device] = loss.item()
        del m, params, loss, step
    num = sum(float((grads["cuda"][n] - g).norm() ** 2) for n, g in grads["cpu"].items())
    den = sum(float(g.norm() ** 2) for g in grads["cpu"].values())
    grad_rel = (num / den) ** 0.5
    loss_rel = abs(losses_32["cuda"] - losses_32["cpu"]) / abs(losses_32["cpu"])
    worst, worst_name = max((rel_l2(grads["cuda"][n], g), n) for n, g in grads["cpu"].items() if float(g.norm()) > 0)
    check(loss_rel <= CNN_CARD_CPU_REL and grad_rel <= CNN_CARD_CPU_REL,
          f"CLIP fp32 step, card vs CPU (B={B_CNN_GRAD}): loss rel {loss_rel:.3e}, gradients global rel L2 "
          f"{grad_rel:.3e} <= {CNN_CARD_CPU_REL:g} (worst tensor {worst:.3e}, {worst_name})")
    print(json.dumps({"model": "clip", "training": {
        "clips_per_s": rate, "ms_per_step": ms, "peak_bytes": peak, "losses": losses, "a2t_correct": a2t,
        "t2a_correct": t2a, "fp32_card_cpu_loss_rel": loss_rel, "fp32_card_cpu_grad_rel": grad_rel},
        "extraction": {"clips_per_s": extract_rate, "batch": B},
        "batch": B_TRAIN, "clip_seconds": EFFNET_CLIP_SAMPLES / 16000, "audio_config": EFFNET_ENTRY}))


def phase_beats_dots(workdir):
    """BEATs training with ``remat_policy="dots"`` (bf16, B=64, 5 s,
    ``fused_qkv=True, use_pallas=True``): ms a step and peak memory beside
    ``remat=False`` and ``remat_policy=None``; K2 24 and K3 12 launches a
    step (the forward's K2 runs again in the backward); then fp32 gradients
    of one step with dropout and LayerDrop on against ``remat=False`` from
    the same generator. Returns the dots run's timed launches."""
    import torch

    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec
    from avex_tpu_torch.training import make_strategy

    layers = beats_config()["encoder_layers"]

    def load(dtype, **init):
        spec = ModelSpec(name="beats", pretrained=False, compute_dtype=dtype,
                         init_config=dict(beats_config(), fused_qkv=True, use_pallas=True, **init))
        return avex_tpu_torch.load_model(spec, random_weights=True, num_classes=N_CLASSES, device="cuda")

    gen = torch.Generator(device="cuda").manual_seed(29)
    batch = {"raw_wav": torch.randn(B_TRAIN, CLIP_SAMPLES, device="cuda", generator=gen) * 0.1,
             "label": torch.randint(0, N_CLASSES, (B_TRAIN,), device="cuda", generator=gen)}
    report, dots_counts = {}, None
    for name, init in (("remat_off", {}), ("remat_nothing", {"remat": True}),
                       ("remat_dots", {"remat": True, "remat_policy": "dots"})):
        twice = 2 if init else 1
        expect = {"fused_qkv_gated_attention": twice * layers, "fused_qkv_gated_attention_backward": layers}
        trainer, losses, ms, rate, peak, counts = train_run("beats", load("bfloat16", **init), batch, expect,
                                                            DOTS_STEPS, workdir / name)
        report[name] = {"ms_per_step": ms, "peak_bytes": peak, "losses": losses}
        if name == "remat_dots":
            dots_counts = counts
        del trainer
        torch.cuda.empty_cache()
    print("BEATs training, remat: " + "; ".join(
        f"{k} {v['ms_per_step']:.1f} ms a step, peak {v['peak_bytes'] / 2**30:.2f} GiB" for k, v in report.items())
        + f" (B={B_TRAIN}, bf16); {CARD[0]}")

    wav = batch["raw_wav"][:B_GRAD_CHECK]
    labels = batch["label"][:B_GRAD_CHECK]
    grads = {}
    for name, init in (("remat_off", {}), ("remat_dots", {"remat": True, "remat_policy": "dots"})):
        model = load("float32", **init)
        model.module.train()
        params = dict(model.module.named_parameters())
        loss, _ = make_strategy("supervised").forward_loss(
            model.train_forward, {"raw_wav": wav, "label": labels}, torch.Generator(device="cuda").manual_seed(3),
            train=True)
        step = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads[name] = (loss.item(), {n: g.float() for n, g in zip(params, step) if g is not None})
        del model, params, loss, step
    (loss_off, g_off), (loss_dots, g_dots) = grads["remat_off"], grads["remat_dots"]
    check(g_off.keys() == g_dots.keys(), "BEATs remat 'dots': the same parameters get gradients as without remat")
    max_d = max(float((g_dots[n] - g).abs().max()) for n, g in g_off.items())
    global_rel, worst, worst_name = gradient_distance(g_dots, g_off)
    check(abs(loss_dots - loss_off) <= PATH_REL * abs(loss_off) and worst <= PATH_REL,
          f"BEATs remat_policy='dots' vs remat=False, fp32 with dropout and LayerDrop (B={B_GRAD_CHECK}): loss "
          f"{loss_dots:.6f} vs {loss_off:.6f}, worst gradient rel L2 {worst:.3e} ({worst_name}), max|d| {max_d:.3e}")
    print(json.dumps({"model": "beats", "remat": report, "dots_vs_off": {
        "loss_rel": abs(loss_dots - loss_off) / abs(loss_off), "worst_grad_rel": worst, "global_grad_rel": global_rel,
        "max_abs_diff": max_d}, "batch": B_TRAIN, "clip_seconds": CLIP_SAMPLES / 16000}))
    return dots_counts


# ---------------------------------------------------------------------------
# Phase 30: data parallelism on the card (spawned ranks)
# ---------------------------------------------------------------------------


def _rank_entry(target: str, rank: int, world: int, workdir: str, kwargs: dict) -> None:
    """What a spawned rank runs: ``target(rank, world, work, **kwargs)``,
    its result pickled, or its traceback written and exit code 1."""
    import pickle
    import traceback

    import torch.distributed as dist

    work = Path(workdir)
    try:
        result = globals()[target](rank, world, work, **kwargs)
        with open(work / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def start_ranks(target: str, world: int, workdir: Path, timeout: float, **kwargs) -> tuple:
    """Spawn ``world`` ranks of ``target`` into a fresh ``workdir``; returns
    the group for :func:`join_ranks`, which gives them ``timeout`` seconds."""
    import multiprocessing
    import shutil

    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(target, rank, world, str(workdir), kwargs))
             for rank in range(world)]
    for proc in procs:
        proc.start()
    return procs, workdir, time.monotonic() + timeout, timeout


def join_ranks(group: tuple) -> tuple:
    """Join a group by its deadline and kill any rank left (a rank blocked in
    a collective by a failed peer never returns). Returns (each rank's
    result or None, the failed ranks' errors, the group's seconds)."""
    import pickle

    procs, workdir, deadline, timeout = group
    for proc in procs:
        proc.join(max(deadline - time.monotonic(), 0.0))
    results, errors = [], []
    for rank, proc in enumerate(procs):
        if proc.is_alive():
            proc.kill()
            proc.join()
            errors.append(f"rank {rank}: still running after {timeout:g} s, killed")
        err = workdir / f"rank{rank}.err"
        if err.exists():
            errors.append(f"rank {rank}:\n{err.read_text()}")
        elif proc.exitcode != 0 and not any(e.startswith(f"rank {rank}:") for e in errors):
            errors.append(f"rank {rank}: exit code {proc.exitcode}")
        out = workdir / f"rank{rank}.pkl"
        results.append(pickle.loads(out.read_bytes()) if out.exists() else None)
    return results, errors, time.monotonic() - (deadline - timeout)


def _join_group(rank: int, world: int, work: Path, backend: str) -> None:
    """This rank into the group over ``backend``, on card 0 (the ranks share it)."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{work / 'rendezvous'}", world_size=world, rank=rank,
                            timeout=timedelta(seconds=DP_COLLECTIVE_TIMEOUT))


def rank_nccl_probe(rank, world, work):
    """(a) Two NCCL ranks on one card: an all-reduce, or NCCL's refusal."""
    import torch
    import torch.distributed as dist

    _join_group(rank, world, work, "nccl")
    x = torch.full((4,), float(rank + 1), device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    return x.tolist()


def dp_beats(dtype: str, dropout: bool):
    """Full-width BEATs ``fused_qkv`` on K2/K3, :data:`DP_LAYERS` deep, with a
    50-class head, seeded random weights (the same in every process); the
    official dropout and LayerDrop, or none."""
    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec

    init = dict(beats_config(), encoder_layers=DP_LAYERS, fused_qkv=True, use_pallas=True)
    if not dropout:
        init.update(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, dropout_input=0.0,
                    encoder_layerdrop=0.0)
    spec = ModelSpec(name="beats", pretrained=False, compute_dtype=dtype, init_config=init)
    return avex_tpu_torch.load_model(spec, random_weights=True, num_classes=N_CLASSES, device="cuda")


def dp_config(work: Path, bsz: int, label_type: str = "supervised", lr: float = DP_LR, sharding: str = "replicated"):
    from avex_tpu_torch.configs import MeshConfig, RunConfig, SchedulerConfig, TrainingParams

    return RunConfig(
        model_spec={"name": "dp"}, output_dir=str(work / f"out_{label_type}_{sharding}"), seed=0,
        training_params=TrainingParams(train_epochs=1, lr=lr, batch_size=bsz, optimizer="adamw", weight_decay=0.01),
        scheduler=SchedulerConfig(name="cosine", warmup_steps=0), label_type=label_type,
        loss_function="clip" if label_type == "text" else "cross_entropy", mesh=MeshConfig(param_sharding=sharding))


def dp_batch(bsz: int, samples: int, seed: int) -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {"raw_wav": torch.randn(bsz, samples, device="cuda", generator=gen) * 0.1,
            "label": torch.randint(0, N_CLASSES, (bsz,), device="cuda", generator=gen)}


def rank_rows(batch: dict, rank: int, world: int) -> dict:
    """The rank's equal share of a global batch: rows [rank·B/W, (rank+1)·B/W)."""
    def take(value):
        n = len(value) // world
        return value[rank * n:(rank + 1) * n]

    return {k: take(v) for k, v in batch.items()}


def params_after(trainer, model) -> dict:
    """Every parameter's value after the steps, whole (ZeRO-3 blocks gathered)."""
    with trainer._whole_params():
        return {n: p.detach().clone() for n, p in model.module.named_parameters()}


def rank_nccl_one(rank, world, work):
    """(b) One rank over NCCL against the same step without a process group:
    the mean over one rank is the identity, so the step is the same bit for
    bit (deterministic algorithms on, in both). Then ZeRO-3 on that rank:
    at one rank every tensor of at least ``fsdp_min_size`` elements is cut
    into one block, so the step runs NCCL's ``all_gather_into_tensor`` and
    ``reduce_scatter_tensor``, and is the same bit for bit too."""
    import os

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from avex_tpu_torch.parallel import make_mesh
    from avex_tpu_torch.training import Trainer

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.cuda.set_device(0)
    model = dp_beats("bfloat16", dropout=True)
    batch = dp_batch(B_TRAIN, CLIP_SAMPLES, seed=30)
    initial = {k: v.clone() for k, v in model.module.state_dict().items()}
    config = dp_config(work, B_TRAIN)
    alone = Trainer(model, config, [batch], steps_per_epoch=4)
    loss_alone = alone._train_step(batch)[0].item()
    after_alone = params_after(alone, model)
    model.module.load_state_dict(initial)
    _join_group(rank, world, work, "nccl")
    mesh = make_mesh(device="cuda")
    trainer = Trainer(model, config, [batch], mesh=mesh, steps_per_epoch=4)
    reset_counts()
    loss = trainer._train_step(batch)[0].item()
    torch.cuda.synchronize()
    counts = read_counts()
    after = params_after(trainer, model)
    out = {"backend": mesh.backend, "size": mesh.size, "loss": loss, "loss_alone": loss_alone, "counts": counts,
           "unequal": [n for n, v in after.items() if not torch.equal(v, after_alone[n])]}
    del trainer, after
    model.module.load_state_dict(initial)
    trainer = Trainer(model, dp_config(work, B_TRAIN, sharding="fsdp"), [batch], mesh=mesh, steps_per_epoch=4)
    out["fsdp_cut"], out["fsdp_params"] = len(trainer._layout.shards), len(trainer._layout.params)
    reset_counts()
    out["fsdp_loss"] = trainer._train_step(batch)[0].item()
    torch.cuda.synchronize()
    out["fsdp_counts"] = read_counts()
    after = params_after(trainer, model)
    out["fsdp_unequal"] = [n for n, v in after.items() if not torch.equal(v, after_alone[n])]
    return out


def step_record(trainer, model, before: dict = None) -> dict:
    """A step's result on the host: every parameter after it and the
    gradient it applied (after one AdamW step the first moment is exactly
    (1 - b1)·g; ZeRO-3 blocks gathered whole); with ``before``, the state
    before the step, the parameters as they were."""
    params = params_after(trainer, model)
    mu = trainer.state.opt_state["mu"]
    if trainer._layout is not None:
        mu = {**mu, **trainer._layout.gather_tensors({n: t for n, t in mu.items() if n in trainer._layout.shards})}
    out = {"params": {n: v.cpu() for n, v in params.items()},
           "grads": {n: (t.float() / 0.1).cpu() for n, t in mu.items()}}
    if before is not None:
        out["before"] = {n: before[n].cpu() for n in out["params"]}
    return out


def shift_free_biases(names) -> set:
    """EfficientNet's projection BatchNorm biases, the last
    ``block.<j>.1.bias`` of each MBConv. In train mode the per-channel shift
    such a bias adds reaches the loss only through 1x1 convolutions into the
    next BatchNorm, whose batch mean takes it away: its exact gradient is 0
    (float64 B0: |g| <= 1e-12 of every other bias's,
    ``tests/test_torch_parallel.py``), and the computed one is rounding noise
    that two correct paths give differently, as the key bias's is."""
    import re

    last: dict = {}
    for n in names:
        m = re.match(r"(.*\.block\.)(\d+)\.1\.bias$", n)
        if m:
            last[m.group(1)] = max(last.get(m.group(1), -1), int(m.group(2)))
    return {f"{prefix}{j}.1.bias" for prefix, j in last.items()}


def held(got: dict, want: dict, lr: float, shift_free: set = frozenset(), teacher_share: float = 0.0) -> dict:
    """The step against the one-process step: the gradients and the
    parameters after it, each by the worst tensor's rel L2 and the rel L2 of
    all of them together.

    Entries whose exact gradient is 0 (the key projection's bias; the
    ``shift_free`` tensors) are left out of the gradients, their largest
    |gradient| reported. Adam's first update is lr·g/(|g| + eps), about ±lr
    however small g is: an entry whose gradient is rounding noise (those
    zero gradients) or near eps moves by what its noise says. So a
    parameter's difference counts only past lr times the distance between
    the two steps' Adam directions (``teacher_share`` of its student's for
    an EMA teacher); that slack's largest entry and the entries it covers
    by more than lr/10 are reported. ``want["before"]``, the parameters
    before the step, shows how far the step moved them."""
    import torch

    def direction(g):
        g = g.double()
        return g / (g.abs() + ADAM_EPS)

    out = {}
    for kind in ("grads", "params"):
        worst, name, noise, num, den, slack_max, slack_n = 0.0, "-", 0.0, 0.0, 0.0, 0.0, 0
        for n, w in want[kind].items():
            g, w = got[kind][n].double(), w.double()
            if kind == "grads":
                mask = torch.ones_like(w, dtype=torch.bool) if n in shift_free else zero_gradient(n, w)
                if mask.any():
                    noise = max(noise, float(g[mask].abs().max()), float(w[mask].abs().max()))
                diff, ref = g[~mask] - w[~mask], w[~mask]
            else:
                source, share = n, 1.0
                if n.startswith("teacher."):
                    source, share = "student." + n[len("teacher."):], teacher_share
                slack = torch.zeros_like(w)
                if source in want["grads"]:
                    slack = share * lr * (direction(got["grads"][source]) - direction(want["grads"][source])).abs()
                    slack_max, slack_n = max(slack_max, float(slack.max())), slack_n + int((slack > lr / 10).sum())
                diff, ref = ((g - w).abs() - slack).clamp_min(0.0), w
            d, r = float(diff.norm()), float(ref.norm())
            num, den = num + d * d, den + r * r
            if r > 0 and d / r >= worst:
                worst, name = d / r, n
        out[kind] = {"worst_rel": worst, "worst": name, "global_rel": (num / den) ** 0.5}
        if kind == "grads":
            out[kind]["zero_max_abs"] = noise
        else:
            out[kind].update(slack_max=slack_max, slack_entries=slack_n,
                             moved_max_abs=max(float((want["params"][n].double() - b.double()).abs().max())
                                               for n, b in want["before"].items()))
    return out


def _ranks_equal(params: dict, mesh) -> bool:
    """Whether every rank holds the same tensors: each tensor's float64 sum,
    rank 0's minus the other's, summed over the two ranks, is exactly 0."""
    import torch
    import torch.distributed as dist

    sums = torch.stack([p.double().sum() for p in params.values()]).to(mesh.device)
    signed = sums * (1.0 if mesh.rank == 0 else -1.0)
    dist.all_reduce(signed, group=mesh.group)
    return bool((signed == 0).all())


def _mean_over_ranks(value: float, mesh) -> float:
    import torch
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, group=mesh.group)
    return float(t) / mesh.size


def _state_bytes(trainer) -> tuple:
    """(parameter bytes, moment bytes) this rank holds between steps."""
    params = sum(p.numel() * p.element_size() for p in trainer.model.module.parameters())
    moments = sum(t.numel() * t.element_size() for m in ("mu", "nu") for t in trainer.state.opt_state[m].values())
    return params, moments


def dp_eat_ssl(noise):
    """Full-width EAT-SSL on K5/K6 (fp32), its mask draw the rows of ``noise``
    from ``offset["rows"]`` on (a rank's rows of the global draw)."""
    from avex_tpu_torch.models import eat_ssl

    model = load_eat_ssl("float32", True)
    offset = {"rows": 0}
    eat_ssl.mask_noise = lambda bsz, n, generator, device: noise[offset["rows"]:offset["rows"] + bsz].to(device)
    return model, offset


def dp_clip():
    """Full-width CLIP (fp32), stochastic depth keeping every item (one
    network for the one-process and the two-rank step)."""
    import torch

    from avex_tpu_torch.models import efficientnet as eff

    eff.stochastic_depth_mask = lambda bsz, keep, generator, device: torch.ones((bsz, 1, 1, 1), dtype=torch.bool,
                                                                                 device=device)
    return load_clip("float32")


def rank_dp(rank, world, work, backend):
    """(c)-(e) on two ranks sharing the card. Rank 0 also takes the
    one-process steps on the global batches (a mesh of its own, no
    collective) from the same initial weights."""
    import torch

    from avex_tpu_torch.ops._precision import full_fp32
    from avex_tpu_torch.parallel import Mesh, average_gradients, make_mesh
    from avex_tpu_torch.training import Trainer

    torch.cuda.set_device(0)
    out = {"rank": rank}
    batch = dp_batch(B_TRAIN, CLIP_SAMPLES, seed=31)
    gen = torch.Generator(device="cuda").manual_seed(32)
    ssl_wav = torch.randn(B_DP_SMALL, EAT_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1
    ssl_noise = torch.rand(B_DP_SMALL, 512, device="cuda", generator=gen)  # 8 x 64 patches
    tones = tone_batches(B_DP_SMALL, EFFNET_CLIP_SAMPLES, seed=33)[0]
    clip_batch = {"raw_wav": tones["raw_wav"], "text_label": captions(tones["label"])}
    alone = Mesh(size=1, rank=0, group=None, device=torch.device("cuda", 0))
    _join_group(rank, world, work, backend)
    mesh = make_mesh(device="cuda")
    out["backend"] = mesh.backend

    # (c) the fp32 step, 32 + 32 clips, against the one-process step on 64
    model = dp_beats("float32", dropout=False)
    initial = {k: v.clone() for k, v in model.module.state_dict().items()}
    if rank == 0:
        trainer = Trainer(model, dp_config(work, B_TRAIN), [], mesh=alone, steps_per_epoch=4)
        ref_loss = trainer._train_step(batch)[0].item()
        ref = step_record(trainer, model, initial)
        del trainer
        model.module.load_state_dict(initial)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(model, dp_config(work, B_TRAIN), [], mesh=mesh, steps_per_epoch=4)
    out["dp_bytes"] = _state_bytes(trainer)
    loss = _mean_over_ranks(trainer._train_step(rank_rows(batch, rank, world))[0].item(), mesh)
    torch.cuda.synchronize()
    out["dp_peak_bytes"] = torch.cuda.max_memory_allocated()
    got = step_record(trainer, model)
    out["dp_ranks_equal"] = _ranks_equal(got["params"], mesh)
    if rank == 0:
        out["dp_loss"], out["ref_loss"], out["dp_held"] = loss, ref_loss, held(got, ref, DP_LR)
    del trainer, got

    # (d) ZeRO-3 on the same ranks and weights, held the same way; its own wall seconds
    torch.cuda.synchronize()
    d_start = time.perf_counter()
    model.module.load_state_dict(initial)
    trainer = Trainer(model, dp_config(work, B_TRAIN, sharding="fsdp"), [], mesh=mesh, steps_per_epoch=4)
    out["fsdp_bytes"] = _state_bytes(trainer)
    out["fsdp_cut"] = len(trainer._layout.shards)
    out["fsdp_resident"] = trainer._layout.resident_bytes()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loss = _mean_over_ranks(trainer._train_step(rank_rows(batch, rank, world))[0].item(), mesh)
    torch.cuda.synchronize()
    out["fsdp_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["fsdp_counts"] = read_counts()
    got = step_record(trainer, model)
    out["fsdp_ranks_equal"] = _ranks_equal(got["params"], mesh)
    if rank == 0:
        out["fsdp_loss"], out["fsdp_held"] = loss, held(got, ref, DP_LR)
    del model, trainer, got, initial
    out["fsdp_seconds"] = time.perf_counter() - d_start

    # (c) the timed bf16 steps with dropout and LayerDrop
    model = dp_beats("bfloat16", dropout=True)
    trainer = Trainer(model, dp_config(work, B_TRAIN), [], mesh=mesh, steps_per_epoch=DP_STEPS + 4)
    local = rank_rows(batch, rank, world)
    trainer._train_step(local)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = time.perf_counter()
    losses = [trainer._train_step(local)[0] for _ in range(DP_STEPS)]
    torch.cuda.synchronize()
    out["ms_per_step"] = (time.perf_counter() - start) / DP_STEPS * 1e3
    out["counts"] = read_counts()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["losses"] = [float(x) for x in losses]
    grads = {n: torch.randn_like(p) for n, p in trainer._trainable.items()}
    average_gradients(grads, mesh)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(DP_STEPS):
        average_gradients(grads, mesh)
    torch.cuda.synchronize()
    out["allreduce_ms"] = (time.perf_counter() - start) / DP_STEPS * 1e3
    out["allreduce_bytes"] = sum(g.numel() * g.element_size() for g in grads.values())
    out["step_wall_ms"], out["busy_share"] = busy_share(lambda: trainer._train_step(local))
    del model, trainer, grads

    # (e) EAT-SSL (K5/K6) and CLIP, 8 + 8 of the global 16
    model, offset = dp_eat_ssl(ssl_noise)
    initial = {k: v.clone() for k, v in model.module.state_dict().items()}
    if rank == 0:
        trainer = Trainer(model, dp_config(work, B_DP_SMALL, "self_supervised"), [], mesh=alone, steps_per_epoch=4)
        ref_loss = trainer._train_step({"raw_wav": ssl_wav})[0].item()
        ref = step_record(trainer, model, initial)
        ref["params"] = {k: v.cpu() for k, v in model.module.state_dict().items()}  # the teacher too
        del trainer
        model.module.load_state_dict(initial)
    offset["rows"] = rank * (B_DP_SMALL // world)
    trainer = Trainer(model, dp_config(work, B_DP_SMALL, "self_supervised"), [], mesh=mesh, steps_per_epoch=4)
    reset_counts()
    loss = _mean_over_ranks(trainer._train_step(rank_rows({"raw_wav": ssl_wav}, rank, world))[0].item(), mesh)
    torch.cuda.synchronize()
    out["ssl_counts"] = read_counts()
    got = step_record(trainer, model)
    got["params"] = {k: v.cpu() for k, v in model.module.state_dict().items()}
    out["ssl_ranks_equal"] = _ranks_equal(got["params"], mesh)
    if rank == 0:
        out["ssl_loss"], out["ssl_ref_loss"], out["ssl_held"] = loss, ref_loss, held(
            got, ref, DP_LR, teacher_share=1.0 - model.ema_decay)
    del model, trainer, got, initial

    model = dp_clip()
    initial = {k: v.clone() for k, v in model.module.state_dict().items()}
    with full_fp32():
        if rank == 0:
            trainer = Trainer(model, dp_config(work, B_DP_SMALL, "text", lr=CLIP_LR), [], mesh=alone,
                              steps_per_epoch=4)
            ref_loss = trainer._train_step(clip_batch)[0].item()
            ref = step_record(trainer, model, initial)
            ref_stats = {k: v.cpu() for k, v in model.module.state_dict().items() if "running" in k}
            del trainer
            model.module.load_state_dict(initial)
        trainer = Trainer(model, dp_config(work, B_DP_SMALL, "text", lr=CLIP_LR), [], mesh=mesh, steps_per_epoch=4)
        reset_counts()
        loss, metrics = trainer._train_step(rank_rows(clip_batch, rank, world))
        torch.cuda.synchronize()
    out["clip_counts"] = read_counts()
    got = step_record(trainer, model)
    stats = {k: v.cpu() for k, v in model.module.state_dict().items() if "running" in k}
    out["clip_ranks_equal"] = _ranks_equal({**got["params"], **stats}, mesh)
    out["clip_count"] = metrics["count"]
    if rank == 0:
        out["clip_loss"], out["clip_ref_loss"], out["clip_held"] = loss.item(), ref_loss, held(
            got, ref, CLIP_LR, shift_free=shift_free_biases(ref["grads"]))
        # every running statistic: the global rel L2, and the worst tensor's max |d|
        num = sum(float((v - ref_stats[k]).double().norm() ** 2) for k, v in stats.items())
        den = sum(float(v.double().norm() ** 2) for v in ref_stats.values())
        worst = max(((v - ref_stats[k]).abs().max().item(), k) for k, v in stats.items())
        out["clip_stats"] = {"rel": (num / den) ** 0.5, "worst_max_abs": worst[0], "worst": worst[1]}
    return out


def phase_data_parallel(workdir: Path) -> dict:
    """Phase 30: the data-parallel ``Trainer`` on spawned ranks; returns the
    kernel launches of the driven runs, summed over ranks."""
    start = time.perf_counter()
    launches = {}

    # (a) does NCCL take two ranks on one card? (b) one rank over NCCL against the step without a
    # process group. The two groups run side by side: their communicators are apart.
    probe = start_ranks("rank_nccl_probe", 2, workdir / "nccl_probe", DP_PROBE_TIMEOUT)
    one = start_ranks("rank_nccl_one", 1, workdir / "nccl_one", DP_TIMEOUT)
    results, errors, seconds = join_ranks(probe)
    nccl_two = not errors and all(r == [3.0] * 4 for r in results)
    backend = "nccl" if nccl_two else "gloo"
    reason = "" if nccl_two else " (" + " | ".join(e.strip().splitlines()[-1] for e in errors) + ")"
    print(f"data parallel (a): NCCL {'takes' if nccl_two else 'refuses'} two ranks on one card{reason}; "
          f"the two-rank runs go over {backend} ({seconds:.1f} s)")

    results, errors, seconds = join_ranks(one)
    check(not errors, f"data parallel (b): the one-rank NCCL run finished ({seconds:.1f} s)"
          + "".join("\n" + e for e in errors))
    if not errors:
        r = results[0]
        check(r["backend"] == "nccl" and r["size"] == 1 and r["loss"] == r["loss_alone"] and not r["unequal"],
              f"data parallel (b): one NCCL rank, Trainer(mesh=...) step == the step without a process group "
              f"(loss {r['loss']:.6f} vs {r['loss_alone']:.6f}; unequal parameters: {r['unequal'][:3]})")
        check(r["fsdp_cut"] > 0 and r["fsdp_loss"] == r["loss_alone"] and not r["fsdp_unequal"],
              f"data parallel (b): ZeRO-3 on one NCCL rank ({r['fsdp_cut']} of {r['fsdp_params']} tensors cut: NCCL's "
              f"all-gather and reduce-scatter ran) step == the step without a process group (loss "
              f"{r['fsdp_loss']:.6f} vs {r['loss_alone']:.6f}; unequal parameters: {r['fsdp_unequal'][:3]})")
        expect = {"fused_qkv_gated_attention": DP_LAYERS, "fused_qkv_gated_attention_backward": DP_LAYERS}
        for key in ("counts", "fsdp_counts"):
            check(all(r[key][k] == expect.get(k, 0) for k in r[key]),
                  f"data parallel (b): {'ZeRO-3 ' if key == 'fsdp_counts' else ''}launches "
                  f"{ {k: v for k, v in r[key].items() if v} } == {expect}")
            for k, v in r[key].items():
                launches[k] = launches.get(k, 0) + v

    # (c)-(e) two ranks sharing the card
    results, errors, seconds = join_ranks(start_ranks("rank_dp", 2, workdir / "two_ranks", DP_TIMEOUT,
                                                      backend=backend))
    check(not errors, f"data parallel (c)-(e): both {backend} ranks finished ({seconds:.1f} s)"
          + "".join("\n" + e for e in errors))
    if not errors:
        r0, r1 = results

        def hold(label, loss, ref_loss, result, ranks_equal, lr, extra=""):
            """Loss, and the worst tensor of the gradients and of the
            parameters after the step, within PATH_REL (see ``held``); the
            step moved the parameters by about lr."""
            rel = abs(loss - ref_loss) / abs(ref_loss)
            p, g = result["params"], result["grads"]
            check(rel <= PATH_REL and p["worst_rel"] <= PATH_REL and g["worst_rel"] <= PATH_REL and ranks_equal
                  and p["moved_max_abs"] >= 0.5 * lr,
                  f"data parallel {label} vs the one-process step on the global batch: loss rel {rel:.3e}; "
                  f"gradients: worst tensor rel L2 {g['worst_rel']:.3e} ({g['worst']}), together {g['global_rel']:.3e} "
                  f"(zero-gradient entries left out, |gradient| <= {g['zero_max_abs']:.1e}); parameters after the "
                  f"step at lr {lr:g} (moved up to {p['moved_max_abs']:.2e}): worst tensor rel L2 "
                  f"{p['worst_rel']:.3e} ({p['worst']}), together {p['global_rel']:.3e}, past the Adam-direction "
                  f"slack (largest {p['slack_max']:.1e}, {p['slack_entries']} entries past lr/10); each <= "
                  f"{PATH_REL:g}; ranks equal {ranks_equal}{extra}")

        hold(f"(c): 2 x {B_TRAIN // 2} clips over {r0['backend']} (fp32)", r0["dp_loss"], r0["ref_loss"],
             r0["dp_held"], r0["dp_ranks_equal"], DP_LR)
        expect = {"fused_qkv_gated_attention": DP_LAYERS * DP_STEPS,
                  "fused_qkv_gated_attention_backward": DP_LAYERS * DP_STEPS}
        for r in results:
            check(all(r["counts"][k] == expect.get(k, 0) for k in r["counts"]),
                  f"data parallel (c): rank {r['rank']} launches { {k: v for k, v in r['counts'].items() if v} } "
                  f"== {expect}")
            check(all(math.isfinite(x) for x in r["losses"]), f"data parallel (c): rank {r['rank']} losses finite")
        print(f"data parallel (c): two ranks sharing one card measure the mechanism, not multi-card speed; "
              f"bf16, dropout and LayerDrop on, {B_TRAIN // 2} clips a rank: "
              + "; ".join(f"rank {r['rank']} {r['ms_per_step']:.1f} ms a step, gradient all-reduce "
                          f"{r['allreduce_ms']:.1f} ms ({r['allreduce_bytes'] / 2**20:.0f} MiB), peak "
                          f"{r['peak_bytes'] / 2**30:.2f} GiB, busy share of its own kernels {r['busy_share']:.3f} "
                          f"(one step under the profiler, {r['step_wall_ms']:.1f} ms)" for r in results)
              + f"; {CARD[0]}")
        hold(f"(d): ZeRO-3, 2 x {B_TRAIN // 2} (fp32)", r0["fsdp_loss"], r0["ref_loss"], r0["fsdp_held"],
             r0["fsdp_ranks_equal"], DP_LR)
        for r in results:
            check(r["fsdp_counts"]["fused_qkv_gated_attention"] == DP_LAYERS
                  and r["fsdp_counts"]["fused_qkv_gated_attention_backward"] == DP_LAYERS,
                  f"data parallel (d): rank {r['rank']} K2 and K3 {DP_LAYERS} launches each")
        print("data parallel (d): ZeRO-3, parameter + moment bytes a rank (DP in brackets): "
              + "; ".join(f"rank {r['rank']} {r['fsdp_bytes'][0] / 2**20:.1f} + {r['fsdp_bytes'][1] / 2**20:.1f} MiB "
                          f"({r['dp_bytes'][0] / 2**20:.1f} + {r['dp_bytes'][1] / 2**20:.1f}), {r['fsdp_cut']} tensors "
                          f"cut (blocks {r['fsdp_resident'][0] / 2**20:.1f} MiB, replicated "
                          f"{r['fsdp_resident'][1] / 2**20:.1f} MiB), fp32 step peak "
                          f"{r['fsdp_peak_bytes'] / 2**30:.2f} GiB (DP {r['dp_peak_bytes'] / 2**30:.2f}), "
                          f"(d) took {r['fsdp_seconds']:.1f} s"
                          for r in results) + f"; {CARD[0]}")
        hold(f"(e): EAT-SSL (K5/K6, fp32), 2 x {B_DP_SMALL // 2}, the mask draw split", r0["ssl_loss"],
             r0["ssl_ref_loss"], r0["ssl_held"], r0["ssl_ranks_equal"], DP_LR)
        expect = {"fused_qkv_attention": 28, "fused_qkv_attention_backward": 16}
        for r in results:
            check(all(r["ssl_counts"][k] == expect.get(k, 0) for k in r["ssl_counts"]),
                  f"data parallel (e): EAT-SSL rank {r['rank']} launches "
                  f"{ {k: v for k, v in r['ssl_counts'].items() if v} } == {expect}")
            check(not any(r["clip_counts"].values()), f"data parallel (e): CLIP rank {r['rank']} launches no kernel")
        stats = r0["clip_stats"]
        # the projection BatchNorm biases' gradients (exactly 0 in train mode, ``shift_free_biases``) are
        # rounding noise and left out; every other tensor is held by itself
        hold(f"(e): CLIP (global-batch BatchNorm, features gathered, fp32), 2 x {B_DP_SMALL // 2}", r0["clip_loss"],
             r0["clip_ref_loss"], r0["clip_held"], r0["clip_ranks_equal"] and r0["clip_count"] == B_DP_SMALL,
             CLIP_LR, f"; {r0['clip_count']} pairs counted")
        check(stats["rel"] <= PATH_REL,
              f"data parallel (e): CLIP's BatchNorm running statistics rel L2 {stats['rel']:.3e} <= {PATH_REL:g} "
              f"(worst tensor max |d| {stats['worst_max_abs']:.2e}, {stats['worst']})")
        for r in results:
            for key in ("counts", "fsdp_counts", "ssl_counts"):
                for k, v in r[key].items():
                    launches[k] = launches.get(k, 0) + v
        print(json.dumps({"data_parallel": {
            "nccl_two_ranks_one_card": nccl_two, "backend": backend, "card": CARD[0],
            "ranks": [{k: r[k] for k in ("rank", "ms_per_step", "allreduce_ms", "allreduce_bytes", "peak_bytes",
                                         "busy_share", "step_wall_ms", "dp_bytes", "fsdp_bytes", "fsdp_resident",
                                         "dp_peak_bytes", "fsdp_peak_bytes", "fsdp_seconds")} for r in results],
            "fp32_checks": {k: r0[k] for k in ("dp_held", "fsdp_held", "ssl_held", "clip_held", "clip_stats")}}}))
    print(f"data parallel: phase 30 took {time.perf_counter() - start:.1f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def mp_config(work: Path, bsz: int, label: str, **mesh):
    from avex_tpu_torch.configs import MeshConfig, RunConfig, SchedulerConfig, TrainingParams

    return RunConfig(
        model_spec={"name": "mp"}, output_dir=str(work / f"out_{label}"), seed=0,
        training_params=TrainingParams(train_epochs=1, lr=DP_LR, batch_size=bsz, optimizer="adamw", weight_decay=0.01),
        scheduler=SchedulerConfig(name="cosine", warmup_steps=0), mesh=MeshConfig(**mesh))


def mp_beats(dtype: str, dropout: bool, **init):
    """Full-width BEATs ``fused_qkv`` on K2/K3 (:func:`dp_beats`), :data:`DP_LAYERS`
    deep as phase 30's (for the script's time), with ``init``."""
    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec

    config = dict(beats_config(), fused_qkv=True, use_pallas=True, encoder_layers=DP_LAYERS)
    config.update(init)
    if not dropout:
        config.update(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, dropout_input=0.0,
                      encoder_layerdrop=0.0)
    spec = ModelSpec(name="beats", pretrained=False, compute_dtype=dtype, init_config=config)
    return avex_tpu_torch.load_model(spec, random_weights=True, num_classes=N_CLASSES, device="cuda")


def mp_eat(dtype: str, **kwargs):
    """Full-width EAT (``esp_aves2_sl_eat_all_ssl_all``'s architecture) on K5/K6."""
    import avex_tpu_torch

    return avex_tpu_torch.load_model("esp_aves2_sl_eat_all_ssl_all", random_weights=True, num_classes=N_CLASSES,
                                     device="cuda", use_pallas=True, compute_dtype=dtype, **kwargs)


def mp_record(trainer, before: dict = None) -> dict:
    """:func:`step_record` under any layout: the whole parameters and the
    gradient the step applied, from what a checkpoint would hold (every
    stage's layers and every rank's block gathered: a collective)."""
    saved = trainer._save_kwargs()
    params = dict(trainer.model.module.named_parameters())
    out = {"params": {n: v.detach().cpu() for n, v in saved["params"].items() if n in params},
           "grads": {n: (t.float() / 0.1).cpu() for n, t in saved["opt_state"]["mu"].items()}}
    if before is not None:
        out["before"] = {n: before[n].cpu() for n in out["params"]}
    return out


def _count_collective_bytes(step) -> dict:
    """The bytes each collective of one call of ``step`` carried on this rank
    (on gloo every collective of the port is an ``all_reduce`` or a
    ``broadcast``)."""
    import torch.distributed as dist

    counted = {"all_reduce": 0, "broadcast": 0}
    real = {name: getattr(dist, name) for name in counted}

    def counting(name):
        def call(tensor, *args, **kwargs):
            counted[name] += tensor.numel() * tensor.element_size()
            return real[name](tensor, *args, **kwargs)
        return call

    for name in counted:
        setattr(dist, name, counting(name))
    try:
        step()
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
    return counted


def rank_mp(rank, world, work, backend):
    """Phase 31's cases on a 1 x 2 mesh (two ranks sharing the card). Rank 0
    also takes each case's one-process step (a mesh of its own, no
    collective) from the same initial weights and batch."""
    import torch

    from avex_tpu_torch.parallel import Mesh, make_mesh
    from avex_tpu_torch.parallel.pipeline import bubble_share
    from avex_tpu_torch.training import Trainer

    import copy

    torch.cuda.set_device(0)
    out = {"rank": rank}
    alone = Mesh(size=1, rank=0, group=None, device=torch.device("cuda", 0))
    _join_group(rank, world, work, backend)
    mesh = make_mesh(1, 2, device="cuda")
    out["backend"], out["coords"] = mesh.backend, (mesh.rank, mesh.model_rank)

    def case(label, net, batch, **mesh_cfg):
        """One fp32 step over the mesh against the one-process step."""
        initial = {k: v.clone() for k, v in net.module.state_dict().items()}
        if rank == 0:
            trainer = Trainer(net, mp_config(work, B_MP_CHECK, label + "_alone"), [], mesh=alone,
                              steps_per_epoch=4)
            ref_loss = trainer._train_step(batch)[0].item()
            ref = mp_record(trainer, initial)
            del trainer
            net.module.load_state_dict(initial)
        trainer = Trainer(net, mp_config(work, B_MP_CHECK, label, **mesh_cfg), [], mesh=mesh, steps_per_epoch=4)
        reset_counts()
        loss = trainer._train_step(batch)[0].item()
        torch.cuda.synchronize()
        out[f"{label}_counts"] = read_counts()
        got = mp_record(trainer)
        out[f"{label}_held_elements"] = sum(p.numel() for p in net.module.parameters())
        if rank == 0:
            out[label] = {"loss": loss, "ref_loss": ref_loss, "held": held(got, ref, DP_LR)}
        del trainer, got, net
        torch.cuda.empty_cache()

    batch = dp_batch(B_MP_CHECK, CLIP_SAMPLES, seed=41)
    # one build (a seeded init of 94M parameters on the host) copied for each case; the stacked
    # layout, which the pipeline and SP need, changes nothing for TP
    beats = mp_beats("float32", dropout=False, scan_layers=True)
    case("tp", copy.deepcopy(beats), batch, data=1, model=2)
    case("pipeline_beats", copy.deepcopy(beats), batch, data=1, model=2, pipeline_microbatches=MP_MICROBATCHES)
    case("sp_tp", beats, batch, data=1, model=2, sequence_parallel=True)
    del beats
    eat_batch = dp_batch(B_MP_CHECK, EAT_CLIP_SAMPLES, seed=42)
    case("pipeline_eat", mp_eat("float32", scan_layers=True, depth=DP_LAYERS), eat_batch, data=1, model=2,
         pipeline_microbatches=MP_MICROBATCHES)
    out["bubble_share"] = bubble_share(2, MP_MICROBATCHES)

    # (a) the timed bf16 TP steps, dropout and LayerDrop on
    model = mp_beats("bfloat16", dropout=True)
    batch = dp_batch(B_MP_TIMED, CLIP_SAMPLES, seed=43)
    trainer = Trainer(model, mp_config(work, B_MP_TIMED, "tp_bf16", data=1, model=2), [], mesh=mesh,
                      steps_per_epoch=MP_STEPS + 4)
    out["tp_bf16_bytes"] = _count_collective_bytes(lambda: trainer._train_step(batch))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = time.perf_counter()
    losses = [trainer._train_step(batch)[0] for _ in range(MP_STEPS)]
    torch.cuda.synchronize()
    out["tp_bf16_ms_per_step"] = (time.perf_counter() - start) / MP_STEPS * 1e3
    out["tp_bf16_counts"] = read_counts()
    out["tp_bf16_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["tp_bf16_losses"] = [float(x) for x in losses]
    out["tp_bf16_held_elements"] = sum(p.numel() for p in model.module.parameters())
    return out


def rank_mp4(rank, world, work, backend):
    """(d) dp x tp on a 2 x 2 mesh of four ranks sharing the card: the fp32
    step against the one-process step on the global batch (rank 0 takes it)."""
    import torch

    from avex_tpu_torch.parallel import Mesh, make_mesh
    from avex_tpu_torch.training import Trainer

    torch.cuda.set_device(0)
    alone = Mesh(size=1, rank=0, group=None, device=torch.device("cuda", 0))
    _join_group(rank, world, work, backend)
    mesh = make_mesh(2, 2, device="cuda")
    out = {"rank": rank, "coords": (mesh.rank, mesh.model_rank)}
    net = mp_beats("float32", dropout=False)
    batch = dp_batch(B_MP_SMALL, CLIP_SAMPLES, seed=44)
    initial = {k: v.clone() for k, v in net.module.state_dict().items()}
    if rank == 0:
        trainer = Trainer(net, mp_config(work, B_MP_SMALL, "dp_tp_alone"), [], mesh=alone, steps_per_epoch=4)
        ref_loss = trainer._train_step(batch)[0].item()
        ref = mp_record(trainer, initial)
        del trainer
        net.module.load_state_dict(initial)
    trainer = Trainer(net, mp_config(work, B_MP_SMALL, "dp_tp", data=2, model=2), [], mesh=mesh, steps_per_epoch=4)
    reset_counts()
    loss = _mean_over_ranks(trainer._train_step(rank_rows(batch, mesh.rank, mesh.size))[0].item(), mesh)
    torch.cuda.synchronize()
    out["counts"] = read_counts()
    got = mp_record(trainer)
    if rank == 0:
        out["loss"], out["ref_loss"], out["held"] = loss, ref_loss, held(got, ref, DP_LR)
    return out


def phase_model_parallel(workdir: Path, dp_tp: bool = False) -> dict:
    """Phase 31: the model axis (tensor parallelism, the GPipe pipeline over
    BEATs and EAT, Megatron-SP with TP) on two spawned ranks sharing the
    card over gloo (NCCL takes no two ranks on one card, phase 30 (a));
    with ``dp_tp`` also (d), dp x tp on four ranks
    (``scripts/torch_model_parallel.py``: the smoke run leaves it out for
    time). Returns the kernel launches of the driven runs, summed over ranks."""
    backend = "gloo"
    start = time.perf_counter()
    launches = {}
    results, errors, seconds = join_ranks(start_ranks("rank_mp", 2, workdir / "model_axis", MP_TIMEOUT,
                                                      backend=backend))
    check(not errors, f"model parallel: both {backend} ranks finished ({seconds:.1f} s)"
          + "".join("\n" + e for e in errors))
    if errors:
        return launches
    r0 = results[0]
    check([r["coords"] for r in results] == [(0, 0), (0, 1)] and r0["backend"] == backend,
          f"model parallel: a 1 x 2 mesh over {r0['backend']}, ranks at {[r['coords'] for r in results]}")
    per = DP_LAYERS // 2 * MP_MICROBATCHES  # a stage's layers times the microbatches
    cases = (
        ("tp", f"(a) TP=2 BEATs fused_qkv ({DP_LAYERS} layers), 6 heads a rank",
         {"fused_qkv_gated_attention": DP_LAYERS, "fused_qkv_gated_attention_backward": DP_LAYERS}),
        ("pipeline_beats", f"(b) GPipe 2 stages x {MP_MICROBATCHES} microbatches, BEATs scan_layers",
         {"fused_qkv_gated_attention": per, "fused_qkv_gated_attention_backward": per}),
        ("pipeline_eat", f"(b) GPipe 2 stages x {MP_MICROBATCHES} microbatches, EAT scan_layers ({DP_LAYERS} "
         f"blocks, 10 s clips)",
         {"fused_qkv_attention": per, "fused_qkv_attention_backward": per}),
        ("sp_tp", "(c) Megatron-SP + TP=2 BEATs (T=248 over 2 ranks)",
         {"fused_qkv_gated_attention": DP_LAYERS, "fused_qkv_gated_attention_backward": DP_LAYERS}),
    )
    for label, what, expect in cases:
        c = r0[label]
        rel = abs(c["loss"] - c["ref_loss"]) / abs(c["ref_loss"])
        p, g = c["held"]["params"], c["held"]["grads"]
        check(rel <= PATH_REL and p["worst_rel"] <= PATH_REL and g["worst_rel"] <= PATH_REL
              and p["moved_max_abs"] >= 0.5 * DP_LR,
              f"model parallel {what}, {B_MP_CHECK} clips, fp32, vs the one-process step: loss rel {rel:.3e}; "
              f"gradients: worst tensor rel L2 {g['worst_rel']:.3e} ({g['worst']}), together {g['global_rel']:.3e} "
              f"(zero-gradient entries left out, |gradient| <= {g['zero_max_abs']:.1e}); parameters after the step "
              f"at lr {DP_LR:g} (moved up to {p['moved_max_abs']:.2e}): worst tensor rel L2 {p['worst_rel']:.3e} "
              f"({p['worst']}), together {p['global_rel']:.3e}, past the Adam-direction slack (largest "
              f"{p['slack_max']:.1e}, {p['slack_entries']} entries past lr/10); each <= {PATH_REL:g}")
        for r in results:
            counts = r[f"{label}_counts"]
            check(all(counts[k] == expect.get(k, 0) for k in counts),
                  f"model parallel {what}: rank {r['rank']} launches { {k: v for k, v in counts.items() if v} } "
                  f"== {expect} (held elements {r[f'{label}_held_elements']:,})")
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
    expect = {"fused_qkv_gated_attention": DP_LAYERS * MP_STEPS,
              "fused_qkv_gated_attention_backward": DP_LAYERS * MP_STEPS}
    for r in results:
        check(all(r["tp_bf16_counts"][k] == expect.get(k, 0) for k in r["tp_bf16_counts"])
              and all(math.isfinite(x) for x in r["tp_bf16_losses"]),
              f"model parallel (a) bf16: rank {r['rank']} launches "
              f"{ {k: v for k, v in r['tp_bf16_counts'].items() if v} } == {expect}, losses finite")
        for k, v in r["tp_bf16_counts"].items():
            launches[k] = launches.get(k, 0) + v
    # (d) dp x tp on four ranks
    results4, errors = [], []
    if dp_tp:
        results4, errors, seconds = join_ranks(start_ranks("rank_mp4", 4, workdir / "model_axis_2x2", MP_TIMEOUT,
                                                           backend=backend))
        check(not errors, f"model parallel (d): the four {backend} ranks finished ({seconds:.1f} s)"
              + "".join("\n" + e for e in errors))
    if results4 and not errors:
        d = results4[0]
        rel = abs(d["loss"] - d["ref_loss"]) / abs(d["ref_loss"])
        p, g = d["held"]["params"], d["held"]["grads"]
        check([r["coords"] for r in results4] == [(0, 0), (0, 1), (1, 0), (1, 1)] and rel <= PATH_REL
              and p["worst_rel"] <= PATH_REL and g["worst_rel"] <= PATH_REL and p["moved_max_abs"] >= 0.5 * DP_LR,
              f"model parallel (d) dp x tp 2 x 2 BEATs, 2 x {B_MP_SMALL // 2} clips, fp32, vs the one-process step: "
              f"loss rel {rel:.3e}; gradients worst tensor rel L2 {g['worst_rel']:.3e} ({g['worst']}); parameters "
              f"(moved up to {p['moved_max_abs']:.2e}) worst tensor rel L2 {p['worst_rel']:.3e} ({p['worst']}), "
              f"past the Adam-direction slack; each <= {PATH_REL:g}")
        expect = {"fused_qkv_gated_attention": DP_LAYERS, "fused_qkv_gated_attention_backward": DP_LAYERS}
        for r in results4:
            check(all(r["counts"][k] == expect.get(k, 0) for k in r["counts"]),
                  f"model parallel (d): rank {r['rank']} launches "
                  f"{ {k: v for k, v in r['counts'].items() if v} } == {expect}")
            for k, v in r["counts"].items():
                launches[k] = launches.get(k, 0) + v
        r0["dp_tp"] = {k: d[k] for k in ("loss", "ref_loss", "held")}
    print(f"model parallel (a): TP=2 on two {backend} ranks sharing one card: the mechanism, not multi-card speed; "
          f"bf16, dropout and LayerDrop on, {B_MP_TIMED} clips on each rank: "
          + "; ".join(f"rank {r['rank']} {r['tp_bf16_ms_per_step']:.1f} ms a step, collectives "
                      f"{r['tp_bf16_bytes']['all_reduce'] / 2**20:.1f} MiB all-reduced and "
                      f"{r['tp_bf16_bytes']['broadcast'] / 2**20:.1f} MiB broadcast a step, peak "
                      f"{r['tp_bf16_peak_bytes'] / 2**30:.2f} GiB, {r['tp_bf16_held_elements']:,} parameter elements"
                      for r in results)
          + f"; GPipe bubble share {r0['bubble_share']:.3f} (2 stages, {MP_MICROBATCHES} microbatches); {CARD[0]}")
    print(json.dumps({"model_parallel": {
        "backend": r0["backend"], "card": CARD[0], "microbatches": MP_MICROBATCHES, "bubble_share": r0["bubble_share"],
        "ranks": [{k: r[k] for k in ("rank", "tp_bf16_ms_per_step", "tp_bf16_bytes", "tp_bf16_peak_bytes",
                                     "tp_bf16_held_elements")} for r in results],
        "fp32_checks": {label: r0[label] for label in [c[0] for c in cases] + ["dp_tp"] if label in r0}}}))
    print(f"model parallel: phase 31 took {time.perf_counter() - start:.1f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    return launches


# ---------------------------------------------------------------------------
# Phase 32: the rest of the model axis (ring attention, expert parallelism,
# Bird-MAE's pipeline and SP, the 3-D dp x pp x tp cell), gloo ranks
# sharing the card
# ---------------------------------------------------------------------------

RING_CLIP_SAMPLES = 30 * 16000  # the CLI's long window: BEATs T = 187 x 8 = 1496 patches
T_RING = 1496
B_RING = 4
RING_TIMED = 3  # bf16 ring forwards timed on each rank
RING_ATOL = 1e-4  # cell 10's bound (__graft_entry__._dryrun_ring_attention)
# the bf16 ring's pooled rel L2 to the same bf16 model in one process on the
# split path the ring replaces; PERF.md has the readings it was set from
RING_BF16_REL = 2e-3
MOE_EXPERTS, MOE_K, MOE_HIDDEN = 8, 2, 256
B_MOE, MOE_STEPS = 64, 4
MOE_LR = 1e-3
MOE_REL = 1e-5  # each step's loss and each parameter (rel L2) against one process
THREE_D_LAYERS = DP_LAYERS  # BEATs at full width in the 3-D cell, 2 layers a stage (cut from 12 for time)
B_3D, THREE_D_MICROBATCHES = 8, 2
THREE_D_LR = 0.1  # the dry run's SGD step
THREE_D_TOL = dict(rtol=1e-4, atol=1e-5)  # __graft_entry__._assert_loss_parity
MP32_TIMEOUT = 600


def ring_model(arch: str, dtype: str = "float32", **init):
    """Full-width BEATs, EAT, AVES or Bird-MAE base for the ring cases, seeded
    random weights, no head; ``init`` goes to BEATs' init config, or to
    EAT's and Bird-MAE's builders (``depth``)."""
    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec

    if arch == "beats":
        spec = ModelSpec(name="beats", pretrained=False, compute_dtype=dtype, init_config=dict(beats_config(), **init))
        return avex_tpu_torch.load_model(spec, random_weights=True, return_features_only=True, device="cuda")
    if arch == "birdmae":
        return load_birdmae(dtype, False, model_id=MAE_BASE, return_features_only=True, **init)
    if arch == "aves":
        spec = ModelSpec(name="aves_bio", pretrained=False, compute_dtype=dtype)
        return avex_tpu_torch.load_model(spec, random_weights=True, return_features_only=True, device="cuda")
    return avex_tpu_torch.load_model("esp_aves2_sl_eat_all_ssl_all", random_weights=True, return_features_only=True,
                                     device="cuda", compute_dtype=dtype, **init)


def rank_mp32(rank, world, work, backend):
    """Phase 32 (a)-(d) on a 1 x 2 mesh of two ranks sharing the card; rank 0
    also takes each case's one-process run from the same weights and inputs."""
    import copy

    import torch

    from avex_tpu_torch.configs import TrainingParams
    from avex_tpu_torch.evaluation.finetune import FineTuneTrainer
    from avex_tpu_torch.ops.ring_attention import ring_bytes
    from avex_tpu_torch.parallel import Mesh, make_mesh
    from avex_tpu_torch.probes import build_probe_from_config
    from avex_tpu_torch.training import Trainer

    torch.cuda.set_device(0)
    alone = Mesh(size=1, rank=0, group=None, device=torch.device("cuda", 0))
    _join_group(rank, world, work, backend)
    mesh = make_mesh(1, 2, device="cuda")
    out = {"rank": rank, "coords": (mesh.rank, mesh.model_rank), "backend": mesh.backend}

    def features(model, args):
        return model.module(*args)[1]["features"]

    def ring_case(label, model, args):
        """fp32 features of the one-process model (rank 0) against the same
        model with ring attention over the two ranks; the ring's launches."""
        with torch.no_grad():
            ref = features(model, args) if rank == 0 else None
            model.enable_ring_attention(mesh)
            reset_counts()
            got = features(model, args)
            torch.cuda.synchronize()
        out[f"{label}_counts"] = read_counts()
        if rank == 0:
            out[label] = {"max_abs": float((got - ref).abs().max()), "shape": tuple(got.shape),
                          "finite": bool(torch.isfinite(got).all()),
                          "pooled": ref.float().mean(1).cpu()}
        return got

    # (a) BEATs on 30 s windows, T = 1496 over a ring of 2
    gen = torch.Generator(device="cuda").manual_seed(51)
    wav = torch.randn(B_RING, RING_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1
    mask = torch.zeros(B_RING, RING_CLIP_SAMPLES, dtype=torch.bool, device="cuda")
    mask[1, RING_CLIP_SAMPLES * 2 // 3:] = True  # one window padded from 20 s
    model = ring_model("beats", encoder_layers=DP_LAYERS)
    ring_case("beats_fp32", model, (wav, mask))
    pooled32 = out["beats_fp32"]["pooled"] if rank == 0 else None
    del model
    model = ring_model("beats", "bfloat16", fused_qkv=True, use_pallas=True,  # the kernels are off under a ring
                       encoder_layers=DP_LAYERS)
    attns = [layer.self_attn for layer in model.module.backbone.encoder.layers]
    with torch.no_grad():
        if rank == 0:  # the one-process bf16 model (K2) against fp32, for the record
            out["beats_bf16_k2_pooled_rel"] = rel_l2(features(model, (wav, mask)).float().mean(1).cpu(), pooled32)
        # the ring's yardstick: the same bf16 model, one process, on the path the
        # ring replaces (the split q/k/v, fp32 logits and softmax, no kernel)
        kept = [(attn.use_pallas, attn.fast_attention) for attn in attns]
        for attn in attns:
            attn.use_pallas, attn.fast_attention = False, False
        pooled_split = features(model, (wav, mask)).float().mean(1).cpu()
        for attn, (use_pallas, fast) in zip(attns, kept):
            attn.use_pallas, attn.fast_attention = use_pallas, fast
    model.enable_ring_attention(mesh)
    with torch.no_grad():
        out["beats_ring_bytes"] = _count_collective_bytes(lambda: features(model, (wav, mask)))
        reset_counts()
        got = features(model, (wav, mask))
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(RING_TIMED):
            got = features(model, (wav, mask))
        torch.cuda.synchronize()
    out["beats_bf16_ms"] = (time.perf_counter() - start) / RING_TIMED * 1e3
    out["beats_bf16_counts"] = read_counts()
    out["beats_payload_bytes"] = DP_LAYERS * ring_bytes(
        torch.empty(B_RING, H, T_RING, D, dtype=torch.bfloat16, device="meta"), mesh.model_size)
    out["beats_bf16_pooled_rel"] = rel_l2(got.float().mean(1).cpu(), pooled_split)
    if rank == 0:
        out["beats_bf16_fp32_pooled_rel"] = rel_l2(got.float().mean(1).cpu(), pooled32)
    # the control: a ring that skips the key chunk that started on rank 1
    import avex_tpu_torch.ops.ring_attention as ring_module

    whole_logits = ring_module._logits

    def skip_chunk(qf, k_c, bias, gate, key_mask, src, chunk, scale):
        logits = whole_logits(qf, k_c, bias, gate, key_mask, src, chunk, scale)
        return torch.full_like(logits, float("-inf")) if src == 1 else logits

    ring_module._logits = skip_chunk
    try:
        with torch.no_grad():
            broken = features(model, (wav, mask))
    finally:
        ring_module._logits = whole_logits
    out["beats_bf16_skip_pooled_rel"] = rel_l2(broken.float().mean(1).cpu(), pooled_split)
    del model, got, broken
    torch.cuda.empty_cache()

    # (b) EAT (T = 513: the pad path), AVES (10 s, T = 499, masked) and Bird-MAE base (T = 513)
    wav = torch.randn(B_RING, EAT_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1
    ring_case("eat_fp32", ring_model("eat", depth=DP_LAYERS), (wav,))
    mask = torch.zeros(B_RING, EAT_CLIP_SAMPLES, dtype=torch.bool, device="cuda")
    mask[2, EAT_CLIP_SAMPLES // 2:] = True
    ring_case("aves_fp32", ring_model("aves"), (wav, mask))
    wav = torch.randn(B_RING, MAE_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1
    ring_case("birdmae_fp32", ring_model("birdmae", depth=DP_LAYERS), (wav,))
    torch.cuda.empty_cache()

    # (c) the MoE probe over 768-wide embeddings, its experts over the two ranks
    config = {"probe_type": "moe", "num_experts": MOE_EXPERTS, "moe_k": MOE_K, "moe_hidden_dim": MOE_HIDDEN,
              "capacity_factor": 2.0, "dropout_rate": 0.0}
    batches = [{"embeddings_0": torch.randn(B_MOE, E, device="cuda", generator=gen),
                "label": torch.randint(0, N_CLASSES, (B_MOE,), device="cuda", generator=gen)}
               for _ in range(MOE_STEPS)]
    params = TrainingParams(train_epochs=1, lr=MOE_LR, batch_size=B_MOE, gradient_clip_val=1.0)

    def moe_run(run_mesh):
        probe = build_probe_from_config(config, num_classes=N_CLASSES, input_dim=E, seed=0, device="cuda")
        trainer = FineTuneTrainer(probe, params, mesh=run_mesh, seed=0)
        trainer._init_optimizer(MOE_STEPS)
        held_now = {n: tuple(p.shape) for n, p in probe.module.named_parameters()}
        losses = [trainer._train_step(b)[0].item() for b in batches]
        if trainer._experts is not None:
            trainer._experts.whole(probe.module)
        return losses, {n: p.detach().clone() for n, p in probe.module.named_parameters()}, held_now

    losses, moe_params, held_now = moe_run(mesh)
    out["moe_held"] = held_now
    if rank == 0:
        ref_losses, ref_params, whole = moe_run(alone)
        out["moe"] = {"losses": losses, "ref_losses": ref_losses, "whole": whole,
                      "worst_param_rel": max(rel_l2(moe_params[n], ref_params[n]) for n in ref_params)}

    # (d) Bird-MAE base: GPipe 2 stages x 4 microbatches, and SP + TP = 2 (T = 513, cut 257 + 256)
    def case(label, net, batch, **mesh_cfg):
        initial = {k: v.clone() for k, v in net.module.state_dict().items()}
        if rank == 0:
            trainer = Trainer(net, mp_config(work, B_MP_CHECK, label + "_alone"), [], mesh=alone, steps_per_epoch=4)
            ref_loss = trainer._train_step(batch)[0].item()
            ref = mp_record(trainer, initial)
            del trainer
            net.module.load_state_dict(initial)
        trainer = Trainer(net, mp_config(work, B_MP_CHECK, label, **mesh_cfg), [], mesh=mesh, steps_per_epoch=4)
        reset_counts()
        loss = trainer._train_step(batch)[0].item()
        torch.cuda.synchronize()
        out[f"{label}_counts"] = read_counts()
        got = mp_record(trainer)
        out[f"{label}_held_elements"] = sum(p.numel() for p in net.module.parameters())
        if rank == 0:
            out[label] = {"loss": loss, "ref_loss": ref_loss, "held": held(got, ref, DP_LR)}
        del trainer, got, net
        torch.cuda.empty_cache()

    bird = load_birdmae("float32", True, model_id=MAE_BASE, num_classes=N_CLASSES, scan_layers=True, depth=DP_LAYERS)
    batch = dp_batch(B_MP_CHECK, MAE_CLIP_SAMPLES, seed=52)
    case("birdmae_pipeline", copy.deepcopy(bird), batch, data=1, model=2, pipeline_microbatches=MP_MICROBATCHES)
    case("birdmae_sp_tp", bird, batch, data=1, model=2, sequence_parallel=True)
    return out


def rank_3d(rank, world, work, backend):
    """Phase 32 (e): the 3-D cell on a 1 x 2 x 2 mesh of four ranks sharing
    the card: BEATs' stacked encoder in two GPipe stages, each stage's
    products cut over ``tp`` (K2/K3 at 6 heads); one SGD step of
    ``mean(features²)``, the loss before and after it. Rank 0 also takes the
    one-process step from the same weights."""
    import copy

    import torch

    from avex_tpu_torch.parallel import make_mesh
    from avex_tpu_torch.parallel.pipeline import shard_pipeline_params

    torch.cuda.set_device(0)
    _join_group(rank, world, work, backend)
    mesh = make_mesh(1, 2, tp=2, device="cuda")
    out = {"rank": rank, "coords": (mesh.rank, mesh.model_rank, mesh.tp_rank)}
    model = mp_beats("float32", dropout=False, scan_layers=True, encoder_layers=THREE_D_LAYERS)
    wav = dp_batch(B_3D, CLIP_SAMPLES, seed=53)["raw_wav"]

    def sgd_step(net, reduce):
        params = dict(net.module.named_parameters())

        def loss_fn():
            return net.module.backbone(wav)[0].float().square().mean()

        loss0 = loss_fn()
        grads = torch.autograd.grad(loss0, list(params.values()), allow_unused=True)
        grads = reduce({n: g if g is not None else torch.zeros_like(p) for (n, p), g in zip(params.items(), grads)})
        with torch.no_grad():
            for n, p in params.items():
                p -= THREE_D_LR * grads[n]
            loss1 = loss_fn()
        return loss0.item(), loss1.item()

    if rank == 0:
        out["ref_losses"] = sgd_step(copy.deepcopy(model), lambda g: g)
    model.enable_pipeline(mesh, THREE_D_MICROBATCHES)
    layout = shard_pipeline_params(model.module, mesh, tp_axis="tp")
    reset_counts()
    start = time.perf_counter()
    out["losses"] = sgd_step(model, layout.reduce_gradients)
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - start
    out["counts"] = read_counts()
    out["tp_cut"], out["held_elements"] = len(layout.cut), sum(p.numel() for p in model.module.parameters())
    return out


def phase_model_axis_rest(workdir: Path) -> dict:
    """Phase 32: (a)-(d) on two gloo ranks sharing the card, (e) on four.
    Returns the kernel launches of the driven runs, summed over ranks."""
    import torch

    backend = "gloo"
    start = time.perf_counter()
    launches: dict = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    results, errors, seconds = join_ranks(start_ranks("rank_mp32", 2, workdir / "model_axis_rest", MP32_TIMEOUT,
                                                      backend=backend))
    check(not errors, f"phase 32: both {backend} ranks finished ({seconds:.1f} s)" + "".join("\n" + e for e in errors))
    if not errors:
        r0 = results[0]
        check([r["coords"] for r in results] == [(0, 0), (0, 1)] and r0["backend"] == backend,
              f"phase 32: a 1 x 2 mesh over {r0['backend']}")
        for label, what in (("beats_fp32", f"(a) BEATs 30 s windows (T={T_RING}), B={B_RING}"),
                            ("eat_fp32", "(b) EAT 10 s (T=513, padded to 514)"),
                            ("aves_fp32", "(b) AVES 10 s (T=499, padded to 500; one clip masked from 5 s)"),
                            ("birdmae_fp32", "(b) Bird-MAE base 10 s at 32 kHz (T=513, padded to 514)")):
            c = r0[label]
            check(c["finite"] and c["max_abs"] <= RING_ATOL,
                  f"phase 32 {what}: fp32 features with ring attention over 2 ranks vs the one-process model: "
                  f"max|Δ| {c['max_abs']:.3e} <= {RING_ATOL:g}, shape {c['shape']}")
            for r in results:
                check(not any(r[f"{label}_counts"].values()), f"phase 32 {what}: rank {r['rank']} launched no kernel")
        ring_rel = max(r["beats_bf16_pooled_rel"] for r in results)
        skip_rel = min(r["beats_bf16_skip_pooled_rel"] for r in results)
        check(ring_rel <= RING_BF16_REL < skip_rel and not any(
                  v for r in results for v in r["beats_bf16_counts"].values()),
              f"phase 32 (a) bf16 BEATs (fused_qkv, use_pallas) under the ring: no kernel launched; pooled rel L2 "
              f"to the same bf16 model in one process on the split path the ring replaces (fp32 softmax) "
              f"{ring_rel:.3e} <= {RING_BF16_REL:g}; a ring that skips one key chunk {skip_rel:.3e} > it (to fp32: "
              f"the ring {r0['beats_bf16_fp32_pooled_rel']:.3e}, the one-process K2 model "
              f"{r0['beats_bf16_k2_pooled_rel']:.3e})")
        m = r0["moe"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(m["losses"], m["ref_losses"]))
        cut_ok = all(results[r]["moe_held"][n][0] * 2 == m["whole"][n][0] for r in range(2)
                     for n in ("head.moe.w1", "head.moe.b1", "head.moe.w2", "head.moe.b2"))
        check(cut_ok and loss_rel <= MOE_REL and m["worst_param_rel"] <= MOE_REL,
              f"phase 32 (c) MoE probe, {MOE_EXPERTS} experts top-{MOE_K} over {E}-wide embeddings, 4 experts a "
              f"rank: {MOE_STEPS} steps' losses rel {loss_rel:.3e}, worst parameter rel L2 "
              f"{m['worst_param_rel']:.3e} against one process, each <= {MOE_REL:g}")
        per_stage = DP_LAYERS // 2 * MP_MICROBATCHES
        for label, what, expect in (
                ("birdmae_pipeline", f"(d) Bird-MAE base ({DP_LAYERS} blocks) GPipe 2 stages x {MP_MICROBATCHES} "
                                     f"microbatches",
                 {"fused_qkv_attention": per_stage, "fused_qkv_attention_backward": per_stage}),
                ("birdmae_sp_tp", "(d) Bird-MAE base SP + TP=2 (T=513 cut 257 + 256)",
                 {"fused_qkv_attention": DP_LAYERS, "fused_qkv_attention_backward": DP_LAYERS})):
            c = r0[label]
            rel = abs(c["loss"] - c["ref_loss"]) / abs(c["ref_loss"])
            p, g = c["held"]["params"], c["held"]["grads"]
            check(rel <= PATH_REL and p["worst_rel"] <= PATH_REL and g["worst_rel"] <= PATH_REL
                  and p["moved_max_abs"] >= 0.5 * DP_LR,
                  f"phase 32 {what}, {B_MP_CHECK} clips, fp32, vs the one-process step: loss rel {rel:.3e}; worst "
                  f"gradient tensor rel L2 {g['worst_rel']:.3e} ({g['worst']}); parameters (moved up to "
                  f"{p['moved_max_abs']:.2e}) worst tensor rel L2 {p['worst_rel']:.3e} ({p['worst']}); each <= "
                  f"{PATH_REL:g}")
            for r in results:
                counts = r[f"{label}_counts"]
                check(all(counts[k] == expect.get(k, 0) for k in counts),
                      f"phase 32 {what}: rank {r['rank']} launches { {k: v for k, v in counts.items() if v} } "
                      f"== {expect} (held elements {r[f'{label}_held_elements']:,})")
                add(counts)
    results3, errors3, seconds3 = join_ranks(start_ranks("rank_3d", 4, workdir / "model_axis_3d", MP32_TIMEOUT,
                                                         backend=backend))
    check(not errors3, f"phase 32 (e): the four {backend} ranks finished ({seconds3:.1f} s)"
          + "".join("\n" + e for e in errors3))
    if not errors3:
        want = results3[0]["ref_losses"]
        per_rank = {"fused_qkv_gated_attention": 2 * THREE_D_LAYERS // 2 * THREE_D_MICROBATCHES,
                    "fused_qkv_gated_attention_backward": THREE_D_LAYERS // 2 * THREE_D_MICROBATCHES}
        close = all(math.isclose(a, b, rel_tol=THREE_D_TOL["rtol"], abs_tol=THREE_D_TOL["atol"])
                    for r in results3 for a, b in zip(r["losses"], want))
        check([r["coords"] for r in results3] == [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)] and close,
              f"phase 32 (e) the 3-D cell 1 x 2 x 2, BEATs {THREE_D_LAYERS} x 768 fp32, B={B_3D}, M="
              f"{THREE_D_MICROBATCHES}: loss before / after one SGD step at lr {THREE_D_LR:g} "
              f"{[r['losses'] for r in results3]} vs one process {want} (rtol {THREE_D_TOL['rtol']:g}, atol "
              f"{THREE_D_TOL['atol']:g})")
        for r in results3:
            check(all(r["counts"][k] == per_rank.get(k, 0) for k in r["counts"]),
                  f"phase 32 (e): rank {r['rank']} {r['coords']} launches "
                  f"{ {k: v for k, v in r['counts'].items() if v} } == {per_rank} (two forwards, one backward; "
                  f"{r['tp_cut']} tensors cut over tp, {r['held_elements']:,} parameter elements held)")
            add(r["counts"])
    if not errors:
        print(f"phase 32 (a): BEATs ring attention over 2 {backend} ranks sharing one card (the mechanism, not "
              f"multi-card speed), bf16, {B_RING} windows of 30 s (T={T_RING}): "
              + "; ".join(f"rank {r['rank']} {r['beats_bf16_ms']:.1f} ms a forward, the ring's payload "
                          f"{r['beats_payload_bytes'] / 2**20:.1f} MiB sent a forward (k/v chunks, 1 hop x {DP_LAYERS} "
                          f"layers), collectives {r['beats_ring_bytes']['all_reduce'] / 2**20:.1f} MiB all-reduced "
                          f"on gloo" for r in results) + f"; {CARD[0]}")
        print(json.dumps({"model_axis_rest": {
            "backend": backend, "card": CARD[0],
            "ring": {k: {kk: vv for kk, vv in results[0][k].items() if kk != "pooled"}
                     for k in ("beats_fp32", "eat_fp32", "aves_fp32", "birdmae_fp32")},
            "ring_bf16": [{k: r[k] for k in ("rank", "beats_bf16_ms", "beats_payload_bytes", "beats_ring_bytes")}
                          for r in results]
            + [{"pooled_rel_to_split": [r["beats_bf16_pooled_rel"] for r in results],
                "skip_chunk_pooled_rel_to_split": [r["beats_bf16_skip_pooled_rel"] for r in results],
                "pooled_rel_to_fp32": results[0]["beats_bf16_fp32_pooled_rel"],
                "k2_pooled_rel_to_fp32": results[0]["beats_bf16_k2_pooled_rel"]}],
            "moe": {k: v for k, v in results[0]["moe"].items() if k != "whole"},
            "birdmae": {k: results[0][k] for k in ("birdmae_pipeline", "birdmae_sp_tp")},
            "three_d": [{k: r.get(k) for k in ("rank", "coords", "losses", "ref_losses", "seconds", "tp_cut",
                                               "held_elements")} for r in results3] if not errors3 else None}}))
    print(f"phase 32 took {time.perf_counter() - start:.1f} s; launches {dict((k, v) for k, v in launches.items() if v)}")
    torch.cuda.synchronize()
    return launches


# ---------------------------------------------------------------------------
# Phase 33: the command line on the card
# ---------------------------------------------------------------------------


def write_wav(path: Path, wav, sr: int) -> None:
    """A 16-bit mono WAV (stdlib ``wave``) of a float waveform in [-1, 1]."""
    import wave

    import numpy as np

    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(np.round(np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes())


def cli_spec(entry: str, **init):
    """An official entry's spec with ``init`` over its init config (the ModelSpec the CLI takes)."""
    from avex_tpu_torch.api.official_models import OFFICIAL_MODELS
    from avex_tpu_torch.configs import ModelSpec

    spec = dict(OFFICIAL_MODELS[entry]["model_spec"])
    return ModelSpec(**dict(spec, init_config=dict(spec.get("init_config") or {}, **init)))


def cli_embed(label: str, spec, src: Path, expect: dict, clip_seconds: float, windowed: bool = False,
              hop_seconds=None) -> tuple:
    """``embed``'s first half (``commands.embed_batches``) into the extraction
    loop (``evaluation.extract_embeddings``, what the HDF5 writer feeds from;
    no h5py here), as ``commands.embed`` runs them. Checks the launches (per
    batch, exact), the batches against the files decoded, resampled and cut
    here (centre crop, or ``window_waveform``), the manifest, and the rows
    against ``model.extract_embeddings`` on those clips (rel ``CLI_ROW_REL``).
    Returns (the launches, the manifest)."""
    import numpy as np
    import torch

    import avex_tpu_torch
    from avex_tpu_torch import commands
    from avex_tpu_torch._native import decode_audio, resample
    from avex_tpu_torch.evaluation import extract_embeddings
    from avex_tpu_torch.ops.audio import pad_or_window_np
    from avex_tpu_torch.ops.windowing import window_waveform

    model = avex_tpu_torch.load_model(spec, random_weights=True, return_features_only=True)
    check(model.device.type == "cuda", f"{label}: the spec's device, cuda")
    mesh = commands.embed_mesh(model, "auto", windowed, clip_seconds, echo=lambda m: print(f"{label}: {m}"))
    check(mesh is None, f"{label}: one rank: ring attention off, no mesh")
    model.register_hooks_for_layers(commands.split_layers("last_layer"))
    files = commands.find_audio_files(src)
    batches, manifest = commands.embed_batches(model, files, clip_seconds=clip_seconds, batch_size=CLI_BATCH,
                                               windowed=windowed, hop_seconds=hop_seconds)
    seen = []

    def recorded():
        for batch in batches:
            seen.append(batch["raw_wav"])
            yield batch

    reset_counts()
    start = time.perf_counter()
    rows = np.concatenate([embs[0] for embs, _labels in extract_embeddings(model, recorded(), aggregation="mean")])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    counts = read_counts()
    for kname, n in counts.items():
        want = expect.get(kname, 0) * len(seen)
        check(n == want, f"{label}: {kname} launched {n} times == {want} ({expect.get(kname, 0)} a batch x "
                         f"{len(seen)} batches)")
    # the clips, decoded, resampled and cut here
    sr = commands.model_sample_rate(model)
    target, hop = int(clip_seconds * sr), int((hop_seconds or clip_seconds) * sr)
    clips, offsets = [], []
    for path in files:
        wav, file_sr = decode_audio(str(path), mono=True)
        wav = resample(wav, file_sr, sr) if file_sr != sr else wav
        if windowed:
            windows, starts = window_waveform(wav, target, hop_samples=hop)
            clips += list(windows)
            offsets += [(str(path), int(s)) for s in starts]
        else:
            clips.append(pad_or_window_np(wav, target, window_selection="center")[0])
            offsets.append((str(path), 0))
    clips = np.stack(clips)
    check(np.array_equal(np.concatenate(seen), clips), f"{label}: {len(clips)} batch rows equal the clips cut here")
    check([(r["path"], r["offset_samples"]) for r in manifest] == offsets,
          f"{label}: the manifest's {len(manifest)} rows (file, offset) equal the cut's")
    with torch.no_grad():
        want = np.concatenate([model.extract_embeddings(clips[i:i + CLI_BATCH], aggregation="mean").float().cpu().numpy()
                               for i in range(0, len(clips), CLI_BATCH)])
    rel = float(np.linalg.norm(rows - want) / np.linalg.norm(want))
    check(rows.shape == want.shape and np.isfinite(rows).all() and rel <= CLI_ROW_REL,
          f"{label}: rows {rows.shape} against model.extract_embeddings on the same clips: rel L2 {rel:.3e}, "
          f"max|d| {float(np.abs(rows - want).max()):.3e} <= rel {CLI_ROW_REL:g} (bit-equal expected)")
    print(f"{label}: {len(files)} files, {len(clips)} rows in {len(seen)} batches, {elapsed:.2f} s "
          f"(decode, resample, extraction) on {CARD[0]}")
    del model
    torch.cuda.empty_cache()
    return counts, manifest


def cli_export(workdir: Path) -> None:
    """(c) ``commands.export`` of the official BEATs (its default plain
    attention, fp32) with a dynamic batch to a ``.pt2`` program, loaded back
    on the card and held to the eager model at B=4 and B=16; the sidecar; a
    ``use_pallas=True`` model refused."""
    import json as json_module

    import numpy as np
    import torch

    import avex_tpu_torch
    from avex_tpu_torch import commands
    from avex_tpu_torch.export import META_FILE, export_program
    from avex_tpu_torch.ops._precision import full_fp32

    spec = cli_spec("esp_aves2_sl_beats_all", encoder_layers=DP_LAYERS)
    out = workdir / "beats.pt2"
    start = time.perf_counter()
    commands.export(spec, out, random_weights=True, clip_seconds=CLIP_SAMPLES / 16000, echo=print)
    export_s = time.perf_counter() - start
    program = torch.export.load(str(out)).module()
    model = avex_tpu_torch.load_model(spec, random_weights=True, return_features_only=True)
    model.register_hooks_for_layers(["last_layer"])
    gen = torch.Generator(device="cuda").manual_seed(33)
    bound = CLI_EXPORT_REL[spec.compute_dtype]
    for bsz in (4, 16):
        wav = torch.randn(bsz, CLIP_SAMPLES, device="cuda", generator=gen) * 0.1
        # an fp32 program runs its convolutions and products with TF32 off, as the eager model does
        with torch.no_grad(), full_fp32():
            got = program(wav)
            want = model.extract_embeddings(wav, aggregation="mean")
        rel = rel_l2(got, want)
        check(got.shape == want.shape == (bsz, E) and got.device.type == "cuda" and rel <= bound,
              f"export: the loaded program at B={bsz} on the card against the eager model ({spec.compute_dtype}): "
              f"pooled rel L2 {rel:.3e} <= {bound:g}")
    meta = json_module.loads((workdir / META_FILE).read_text())
    want_meta = {"mode": "embed", "sample_rate": 16000, "clip_seconds": CLIP_SAMPLES / 16000,
                 "n_samples": CLIP_SAMPLES, "layers": ["last_layer"], "aggregation": "mean"}
    check(meta == want_meta, f"export: the sidecar {META_FILE} holds {meta}")
    kernels = avex_tpu_torch.load_model(cli_spec("esp_aves2_sl_beats_all", use_pallas=True), random_weights=True,
                                        return_features_only=True)
    try:
        export_program(kernels, workdir / "kernels.pt2", clip_seconds=CLIP_SAMPLES / 16000)
        check(False, "export: a use_pallas=True model is refused")
    except ValueError as err:
        check("use_pallas=True" in str(err), f"export: a use_pallas=True model is refused: {err}")
    print(f"export: the program written in {export_s:.1f} s ({out.stat().st_size / 2**20:.1f} MiB) on {CARD[0]}")
    del model, kernels, program
    torch.cuda.empty_cache()


_SERVE_CHILD = """
import json
from avex_tpu_torch import commands
from avex_tpu_torch.configs import ModelSpec
from avex_tpu_torch.ops import attention_kernels as ak, int8_kernels as ik
spec = ModelSpec(**{spec!r})
commands.serve([spec], port=0, clip_seconds={clip_seconds!r}, max_batch={max_batch!r}, random_weights=True,
               quantization="int8")
print("LAUNCHES " + json.dumps({{**ak.LAUNCHES, **ik.LAUNCHES}}), flush=True)
"""


def cli_serve() -> None:
    """(d) ``commands.serve`` in a child process (the foreground server):
    int8 BEATs on K1/K7, port 0; 32 clips posted from 8 threads, each row
    held to the same int8 model in this process; SIGINT ends it with exit
    code 0 and frees the port. The child prints its own launch counts on
    its way out: 4 K1 and 24 K7 a forward of BEATs cut to :data:`DP_LAYERS`
    (warm-up and served batches),
    no other kernel. They are the child's process's and are not added to
    the ``kernels`` line."""
    import concurrent.futures as futures
    import io
    import os
    import signal
    import socket
    import urllib.request

    import numpy as np
    import torch

    import avex_tpu_torch

    spec = cli_spec("esp_aves2_sl_beats_all", use_pallas=True, encoder_layers=DP_LAYERS).replace(
        compute_dtype="bfloat16")
    code = _SERVE_CHILD.format(spec=spec.to_dict(), clip_seconds=CLIP_SAMPLES / 16000, max_batch=CLI_SERVED)
    env = dict(os.environ, LOG_LEVEL="WARNING")
    start = time.perf_counter()
    child = subprocess.Popen([sys.executable, "-c", code], cwd=str(Path(__file__).resolve().parent), env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    url, lines = None, []
    try:
        deadline = time.monotonic() + CLI_SERVE_START
        while url is None and time.monotonic() < deadline:
            line = child.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("Serving "):
                url = line.rsplit(" on ", 1)[1].strip()
        check(url is not None, "serve: the child printed 'Serving beats (embed) on http://...'"
              + ("" if url else ":\n" + "".join(lines[-20:])))
        if url is None:
            return
        up_s = time.perf_counter() - start
        rng = np.random.default_rng(34)
        clips = [(rng.standard_normal(CLIP_SAMPLES) * 0.1).astype(np.float32) for _ in range(CLI_SERVED)]

        def post(wav):
            body = io.BytesIO()
            np.save(body, wav)
            request = urllib.request.Request(url + "/embed", data=body.getvalue(), method="POST")
            with urllib.request.urlopen(request, timeout=SERVE_TIMEOUT) as response:
                return np.asarray(json.loads(response.read())["output"], np.float32)

        t0 = time.perf_counter()
        with futures.ThreadPoolExecutor(CLI_SERVE_THREADS) as pool:
            rows = np.stack(list(pool.map(post, clips)))
        served_s = time.perf_counter() - t0
        child.send_signal(signal.SIGINT)
        t1 = time.perf_counter()
        try:
            code_out = child.wait(timeout=CLI_SIGINT_EXIT)
        except subprocess.TimeoutExpired:
            code_out = None
        check(code_out == 0, f"serve: SIGINT: the child exited with {code_out} within {CLI_SIGINT_EXIT} s "
                             f"({time.perf_counter() - t1:.2f} s)")
        tail = child.stdout.read() if code_out is not None else ""
        counted = [json.loads(ln.split(" ", 1)[1]) for ln in tail.splitlines() if ln.startswith("LAUNCHES ")]
        child_counts = counted[0] if counted else {}
        forwards = child_counts.get("gated_bias_attention", 0) // DP_LAYERS
        k7_per_forward = DP_LAYERS * sum(INT8_PER_LAYER.values())
        others = {k: v for k, v in child_counts.items() if k not in ("gated_bias_attention", "int8_dynamic_dense")
                  and v}
        check(forwards > 0 and child_counts["gated_bias_attention"] == DP_LAYERS * forwards
              and child_counts.get("int8_dynamic_dense", 0) == k7_per_forward * forwards and not others,
              f"serve: the child's launches {child_counts or tail[-2000:]}: {DP_LAYERS} K1 and {k7_per_forward} K7 "
              f"a forward "
              f"({forwards} forwards), no other kernel")
        port = int(url.rsplit(":", 1)[1])
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind(("127.0.0.1", port))
                free = True
            except OSError:
                free = False
        check(free, f"serve: port {port} free after the child's exit")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    model = avex_tpu_torch.load_model(spec, random_weights=True, return_features_only=True, quantization="int8")
    model.register_hooks_for_layers(["last_layer"])
    with torch.no_grad():
        want = model.extract_embeddings(np.stack(clips), aggregation="mean").float().cpu().numpy()
    rels = np.linalg.norm(rows - want, axis=1) / np.linalg.norm(want, axis=1)
    check(rows.shape == want.shape and float(rels.max()) <= SERVE_REL,
          f"serve: {len(rows)} rows from the child's int8 BEATs against the same int8 model here: worst rel "
          f"{float(rels.max()):.3e} <= {SERVE_REL:g}")
    print(f"serve: child up in {up_s:.1f} s (imports, build, int8, warm-up), {CLI_SERVED} requests from "
          f"{CLI_SERVE_THREADS} threads in {served_s * 1e3:.1f} ms; the child's own launches {child_counts} "
          f"(not added to the kernels line); on {CARD[0]}")
    del model
    torch.cuda.empty_cache()


def cli_grain_train(workdir: Path) -> dict:
    """(e) ``run_train.main`` with ``data_pipeline="grain"``: an uninterrupted
    run, a run stopped mid-epoch (the preemption flag SIGTERM's handler sets,
    after step ``GRAIN_STOP``: its step checkpoint holds the loader's
    position) and a run resumed from that checkpoint. Returns the launches."""
    import hashlib
    import shutil

    import numpy as np
    import torch

    import avex_tpu_torch.run_train as run_train
    from avex_tpu_torch.configs import RunConfig
    from avex_tpu_torch.data import GrainDataLoader
    from avex_tpu_torch.training import Trainer

    data = workdir / "grain_data"
    if not (data / "metadata.csv").exists():  # phase 15's kind of clips, fewer
        write_tone_wavs(data, GRAIN_CLIPS, seed=31)
    shutil.rmtree(workdir / "grain", ignore_errors=True)

    def config(name, **extra):
        return RunConfig.from_dict(dict(
            model_spec=entry_model_spec(fused_qkv=True, encoder_layers=DP_LAYERS), data_pipeline="grain",
            device="cuda", seed=0,
            training_params={"train_epochs": GRAIN_EPOCHS, "lr": ENTRY_LR, "batch_size": B_GRAIN,
                             "optimizer": "adamw", "weight_decay": 0.01},
            dataset_config={"train_datasets": [{"name": "train", "kind": "local", "path": str(data)}]},
            output_dir=str(workdir / "grain" / name), checkpoint_every_steps=GRAIN_CHECKPOINT_EVERY,
            logging="none", num_workers=ENTRY_WORKERS, **extra))

    records, loaders = [], []
    step, build = Trainer._train_step, run_train.build_dataloaders

    def recorded(self, batch):
        digest = hashlib.sha256(batch["raw_wav"].numpy().tobytes() + batch["label"].numpy().tobytes()).hexdigest()
        loss, metrics = step(self, batch)
        records[-1].append((digest, float(loss), time.perf_counter()))  # float(): the step has ended
        if self.config.output_dir.endswith("stopped") and len(records[-1]) == GRAIN_STOP:
            self._preempted = True  # what SIGTERM's handler sets: save the step checkpoint and stop
        return loss, metrics

    def capture(cfg):
        out = build(cfg)
        loaders.append(out[0])
        return out

    total, runs = {}, {}
    Trainer._train_step, run_train.build_dataloaders = recorded, capture
    try:
        for name, extra in (("whole", {}), ("stopped", {}),
                            ("resumed", {"resume_from_checkpoint": str(workdir / "grain" / "stopped" /
                                                                       "step_checkpoint")})):
            records.append([])
            reset_counts()
            start = time.perf_counter()
            result = run_train.main(config(name, **extra))
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
            counts = read_counts()
            steps = len(records[-1])
            expect = {"fused_qkv_gated_attention": DP_LAYERS * steps,
                      "fused_qkv_gated_attention_backward": DP_LAYERS * steps}
            for kname, n in counts.items():
                check(n == expect.get(kname, 0), f"grain {name}: {kname} launched {n} times == "
                                                 f"{expect.get(kname, 0)} ({DP_LAYERS} a step x {steps} steps)")
                total[kname] = total.get(kname, 0) + n
            loader = loaders[-1]
            check(isinstance(loader, GrainDataLoader), f"grain {name}: data_pipeline='grain' built a GrainDataLoader")
            runs[name] = (result, list(records[-1]), elapsed, loader.wait_seconds / max(loader.batches_served, 1))
    finally:
        Trainer._train_step, run_train.build_dataloaders = step, build
    whole, stopped, resumed = ([r[:2] for r in runs[k][1]] for k in ("whole", "stopped", "resumed"))
    meta = json.loads((workdir / "grain" / "stopped" / "step_checkpoint.meta.json").read_text())
    check(runs["stopped"][0].get("preempted") and len(stopped) == GRAIN_STOP
          and meta["loader_state"]["position"] == GRAIN_STOP - GRAIN_STEPS and meta["loader_state"]["epoch"] == 1,
          f"grain: the stopped run saved its step checkpoint after step {len(stopped)} with the loader at "
          f"{meta['loader_state']}")
    check(len(whole) == GRAIN_STEPS * GRAIN_EPOCHS and [d for d, _ in stopped + resumed] == [d for d, _ in whole],
          f"grain: the {len(resumed)} batches after the resume (and the {len(stopped)} before it) equal the "
          f"uninterrupted run's bit for bit (sha256 of raw_wav and labels)")
    rels = [abs(a - b) / abs(b) for (_, a), (_, b) in zip(resumed, whole[len(stopped):])]
    check(len(rels) == len(resumed) and max(rels) <= GRAIN_LOSS_REL,
          "grain: each resumed step's loss within rel %g of the uninterrupted run's: %s" % (
              GRAIN_LOSS_REL, ", ".join(f"{r:.2e}" for r in rels)))
    for name, (_result, rec, elapsed, wait) in runs.items():
        gaps = np.diff([t for _, _, t in rec]) * 1e3
        print(f"grain {name}: {len(rec)} steps in {elapsed:.1f} s with the model's build and {ENTRY_WORKERS} "
              f"workers' start; from step to step (loader included) median {float(np.median(gaps)):.1f} ms, "
              f"min {float(gaps.min()):.1f} ms; the loader's wait {wait * 1e3:.1f} ms a batch; losses "
              + " ".join(f"{loss:.5f}" for _, loss, _ in rec))
    return total


def phase_cli(workdir: Path) -> dict:
    """Phase 33: the command line's bodies (``avex_tpu_torch.commands``) on
    the card. Returns the launches of every kernel in (a), (b) and (e)."""
    import numpy as np

    start = time.perf_counter()
    rng = np.random.default_rng(33)
    for i in range(CLI_CLIPS + CLI_RESAMPLED):  # (a): 6 s clips, the last ones at 44.1 kHz
        sr = 44100 if i >= CLI_CLIPS else 16000
        write_wav(workdir / "clips" / f"clip{i:03d}.wav", rng.standard_normal(6 * sr) * 0.1, sr)
    for i in range(CLI_LONG_N):  # (b): long recordings
        write_wav(workdir / "long" / f"rec{i}.wav", rng.standard_normal(CLI_LONG_S * 16000) * 0.1, 16000)
    print(f"cli: {CLI_CLIPS + CLI_RESAMPLED} clips and {CLI_LONG_N} {CLI_LONG_S} s recordings written in "
          f"{time.perf_counter() - start:.1f} s")
    total = {}

    def add(counts):
        for kname, n in counts.items():
            total[kname] = total.get(kname, 0) + n

    counts, _ = cli_embed("embed (a) BEATs, centre crop", cli_spec("esp_aves2_sl_beats_all", use_pallas=True,
                                                                   encoder_layers=DP_LAYERS),
                          workdir / "clips", {"gated_bias_attention": DP_LAYERS}, CLIP_SAMPLES / 16000)
    add(counts)
    counts, _ = cli_embed("embed (b) BEATs fused_qkv, 30 s windows", cli_spec(
        "esp_aves2_sl_beats_all", use_pallas=True, fused_qkv=True, encoder_layers=DP_LAYERS), workdir / "long",
        {"fused_qkv_gated_attention": DP_LAYERS}, CLI_WINDOW_BEATS, windowed=True, hop_seconds=CLI_HOP_BEATS)
    add(counts)
    counts, _ = cli_embed("embed (b) EAT, 10 s windows", cli_spec("esp_aves2_sl_eat_all_ssl_all", use_pallas=True),
                          workdir / "long", {"fused_qkv_attention": 12}, CLI_WINDOW_EAT, windowed=True)
    add(counts)
    cli_export(workdir)
    cli_serve()
    add(cli_grain_train(workdir))
    print(f"phase 33 (the command line): {time.perf_counter() - start:.1f} s; launches "
          f"{ {k: v for k, v in total.items() if v} } on {CARD[0]}")
    return total


# ---------------------------------------------------------------------------
# Phase 34: the attention kernels at head widths other than 64 and 80
# ---------------------------------------------------------------------------

# E = 768 held, so that every bound equals dh 64's: 48, 24, 8 and 6 heads.
HW_WIDTHS = (16, 32, 96, 128)
HW_RAGGED_B, HW_RAGGED_T = 8, 37  # one ragged tile, a key mask
BEATS_DH128_HEADS, EAT_DH32_HEADS = 6, 24  # full width and depth, only the head count changed
B_HW_FP32 = 16  # the fp32 kernel-vs-plain extraction checks (the plain path holds [B, H, T, T] fp32)
EXAMPLE_RUN_CONFIG = "configs/run_configs/beats_supervised_example.yml"


def sdpa_backend(q, k, v, attn_mask=None) -> str:
    """Which of ``scaled_dot_product_attention``'s backends its dispatcher
    picks for these operands (``torch._fused_sdp_choice``, the choice
    ``F.scaled_dot_product_attention`` makes)."""
    import torch
    from torch.nn.attention import SDPBackend

    try:
        choice = torch._fused_sdp_choice(q, k, v, attn_mask, 0.0, False, scale=q.shape[-1] ** -0.5)
        return SDPBackend(choice).name.lower()
    except (AttributeError, RuntimeError, TypeError, ValueError) as exc:
        return f"unknown ({type(exc).__name__})"


# The FMA body's times at phase 35's timed shapes (PERF.md's phase-35 table, an
# NVIDIA H100 80GB HBM3 at 700 W), quoted beside the 3xTF32
# kernels that replaced it: K1/K2 at B=128, T=248 with the gate, K4/K5 at
# B=128, T=513, K3 at B=64, T=248 with the gate, K6 at B=64, T=513.
FMA_FORWARD_MS = {
    "K1": {12: 4.4212, 20: 2.5834, 136: 2.6956, 192: 2.5641, 256: 2.9753, 320: 3.5780},
    "K2": {12: 4.5195, 20: 2.6493, 136: 2.7314, 192: 2.5813, 256: 3.0000, 320: 3.6020},
    "K4": {12: 18.5036, 20: 10.4464, 136: 11.6032, 192: 10.2038, 256: 12.5762, 320: 15.5377},
    "K5": {12: 18.8884, 20: 10.8340, 136: 11.7656, 192: 10.2770, 256: 12.6695, 320: 15.6373},
}
FMA_BACKWARD_MS = {
    "K3": {12: 13.6896, 20: 9.0996, 136: 9.8768, 192: 9.0484, 256: 9.0525, 320: 11.5444},
    "K6": {12: 39.5219, 20: 23.0681, 136: 41.5021, 192: 35.0215, 256: 38.3390, 320: 50.8536},
}
# K1-K6 by the wrapper's names
KERNEL_NUMBERS = {"gated_bias_attention": "K1", "fused_qkv_gated_attention": "K2", "plain_attention": "K4",
                  "fused_qkv_attention": "K5"}


def fma_quote(kernel: str, dh: int, ms: float) -> str:
    """The tail of a timed fp32 line in phase 35 where PERF.md has the FMA
    body's time for it (``FMA_FORWARD_MS``, ``FMA_BACKWARD_MS``): that time
    as a quoted figure."""
    fma = {**FMA_FORWARD_MS, **FMA_BACKWARD_MS}[kernel].get(dh)
    return "" if fma is None else f"; the FMA body (quoted from PERF.md) {fma:.4f} ms ({fma / ms:.2f}x this)"


def backward_quote(kernel: str, dh: int, ms: float, q, k, v, attn_mask) -> str:
    """The tail of a timed fp32 backward's line in phase 35: SDPA's backend
    for the same views and, where PERF.md has it, the FMA backward's time
    as a quoted figure."""
    return f"; sdpa backend {sdpa_backend(q, k, v, attn_mask)}" + fma_quote(kernel, dh, ms)


def head_width_kernels(phase: int, widths, timed, heads_of, seed: int, twin_bytes=None, padded_item=False,
                       reps: int = TIMED_LAUNCHES, check_batch=None):
    """K1-K6 at each head width of ``widths`` with ``heads_of(dh)`` heads,
    bf16 (tensor cores) and fp32 (on 3xTF32, forward and backward, each
    call's body checked, each fp32 forward within max|d| 1e-4 and rel L2
    1e-5 of its twin and K2's and K5's saved row log-sum-exp within 1e-5 of
    the twin's): the
    forwards at B=128 (K4, K5:
    T=513; K1, K2: T=248, with the gate), the backwards at B=64 (K3: T=248,
    with the gate; K6: T=513), each against its twin (the bf16 K3/K6 also
    against the twin of their own contract on the forward's residuals); a
    width of ``timed`` is timed beside the twin, its bound and SDPA (and,
    with ``twin_bytes`` set, SDPA's backend printed; the fp32 forwards and
    backwards beside the 3xTF32 bound, SDPA's backend and, at the widths of
    ``FMA_FORWARD_MS`` and ``FMA_BACKWARD_MS``, the FMA body's time quoted
    from PERF.md),
    each time the median of ``reps`` calls; then one ragged, padded
    case a width (B=8, T=37, a key mask; with ``padded_item`` also one item's
    keys all padded in the forwards: NaN where the twin has NaN). With
    ``twin_bytes`` a batch is cut so that the twin's fp32 [B, H, T, T]
    logits stay within it (many narrow heads); with ``check_batch`` a width
    that is not timed is checked at that batch. Returns per-kernel numbers
    by (kernel, dh, dtype), the launches, and the batches and heads used."""
    import torch
    import torch.nn.functional as F

    from avex_tpu_torch.ops import attention_kernels as ak

    gen = torch.Generator(device="cuda").manual_seed(seed)
    results, shapes = {}, {}
    reset_counts()

    def fit(bsz, heads, seq):
        if twin_bytes is None:
            return bsz
        return max(1, min(bsz, int(twin_bytes // (heads * seq * seq * 4))))

    def held(label, dtype, got, want, sums=False, tf32x3=False):
        """NaN exactly where the twin has NaN; elsewhere fp32 max|d| (sums:
        relative L2, dbias and dgate sum in another order; ``tf32x3``, an
        fp32 backward on the 3xTF32 kernels: relative L2 too) or bf16
        relative L2 against the twin. Returns max|d|."""
        nan = torch.isnan(want)
        check(got.shape == want.shape and torch.equal(torch.isnan(got), nan)
              and bool(torch.isfinite(got[~nan]).all()), f"{label}: finite, NaN where the twin has NaN")
        got, want = got[~nan].float(), want[~nan].float()
        err, rel = float((got - want).abs().max()), rel_l2(got, want)
        if dtype == torch.float32 and tf32x3 and not sums:
            check(rel <= TF32X3_REL_L2, f"{label}: rel L2={rel:.3e} <= {TF32X3_REL_L2:g} (3xTF32)")
        if dtype == torch.float32 and sums:
            check(rel <= FP32_SUM_REL, f"{label}: rel L2={rel:.3e} <= {FP32_SUM_REL:g} (max|d| {err:.3e})")
        elif dtype == torch.float32:
            check(err <= FP32_ATOL, f"{label}: max|d|={err:.3e} <= {FP32_ATOL:g} (rel {rel:.3e})")
        else:
            check(rel <= BF16_REL_L2, f"{label}: rel L2={rel:.3e} <= {BF16_REL_L2:g} (max|d| {err:.3e})")
        return err

    def record(kname, dh, name, label, err, run, twin, library, bound, flops, sdpa_operands, fp32):
        """Time a forward; an fp32 one (on 3xTF32) adds SDPA's backend and,
        at the widths of ``FMA_FORWARD_MS``, the FMA body's quoted time."""
        ms, plain_ms, library_ms = median_ms(run, reps), median_ms(twin, reps), median_ms(library, reps)
        t_bound, bound_by = bound
        backend = f", sdpa backend {sdpa_backend(*sdpa_operands)}" if twin_bytes is not None and not fp32 else ""
        fp32_numbers, note = ({}, "")
        if fp32:
            fp32_numbers, note = fp32_forward_timing(*sdpa_operands)
            note += fma_quote(KERNEL_NUMBERS[kname], dh, ms)
        print(f"time {label}: kernel {ms:.4f} ms ({tflops(flops, ms):.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
              f"sdpa {library_ms:.4f} ms, bound {t_bound:.4f} ms by {bound_by} ({t_bound / ms:.1%} of bound)"
              f"{backend}{note}; {CARD[0]}")
        results[(kname, dh, name)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                          bound_ms=t_bound, bound_by=bound_by, **fp32_numbers)

    for dh in widths:
        heads = heads_of(dh)
        e = heads * dh
        forward_b, backward_b = (B, B_TRAIN) if check_batch is None or dh in timed else (check_batch, check_batch)
        bsz_f, bsz_g = fit(forward_b, heads, T_EAT), fit(forward_b, heads, T)
        bsz_b3, bsz_b6 = fit(backward_b, heads, T), fit(backward_b, heads, T_EAT)
        shapes[dh] = dict(heads=heads, forward_batch=[bsz_g, bsz_f], backward_batch=[bsz_b3, bsz_b6])
        plan = ak.width_plan(dh)
        print(f"phase {phase}: dh {dh}, {heads} heads (E = {e}), build {plan.build}, {plan.chunks} column chunk(s) "
              f"of {plan.chunk_width}; forward batches {bsz_g} / {bsz_f}, backward {bsz_b3} / {bsz_b6}")
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            # the forwards' and backwards' body: bf16, or fp32 on 3xTF32 at every width
            fwd_body = bwd_body = "bf16" if dtype == torch.bfloat16 else "tf32x3"
            tf32x3 = fp32 = dtype == torch.float32
            body = bwd_label = "tensor cores, 3xTF32" if fp32 else "tensor cores"

            def forward_held(label, run, twin):
                """One forward against its twin, on the body the rule gives; returns max|d|."""
                got, bodies = bodies_of(run, forward=True)
                check(bodies == {fwd_body: 1}, f"{label}: ran on the {fwd_body} body ({bodies})")
                return held(label, dtype, got, twin(), tf32x3=tf32x3)
            # bias-free forwards, EAT's T: K5 on [B, T, 3E], K4 on its split views
            qkv = torch.randn(bsz_f, T_EAT, 3 * e, device="cuda", generator=gen).to(dtype)
            q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(bsz_f, T_EAT, 3, heads, dh).unbind(2))
            bound = attention_bound_ms(name, gated=False, padded=False, seq=T_EAT, heads=heads, dim=dh, bsz=bsz_f,
                                       tf32x3=tf32x3)
            flops = 4.0 * bsz_f * heads * T_EAT * T_EAT * dh
            with torch.no_grad():
                for kname, run, twin in (
                    ("fused_qkv_attention", lambda: ak.fused_qkv_attention(qkv, heads),
                     lambda: ak.fused_qkv_reference(qkv, heads)),
                    ("plain_attention", lambda: ak.gated_bias_attention(q, k, v, None),
                     lambda: ak.gated_bias_attention_reference(q, k, v, None)),
                ):
                    label = f"{kname} dh={dh} H={heads} B={bsz_f} T={T_EAT} {name} ({body})"
                    err = forward_held(label, run, twin)
                    if dh in timed:
                        record(kname, dh, name, label, err, run, twin,
                               lambda: F.scaled_dot_product_attention(q, k, v, scale=dh**-0.5), bound, flops,
                               (q, k, v), fp32)
                if fp32:  # the row log-sum-exp the 3xTF32 K5 saves
                    lse_held(f"fused_qkv_attention dh={dh} H={heads} B={bsz_f} T={T_EAT} {name}", qkv, heads)
            del qkv, q, k, v
            # gated forwards, BEATs' T, with the gate: K1 on three projections' views, K2 on [B, T, 3E]
            qkv = torch.randn(bsz_g, T, 3 * e, device="cuda", generator=gen).to(dtype)
            sq, sk, sv = (torch.randn(bsz_g, T, e, device="cuda", generator=gen).to(dtype)
                          .view(bsz_g, T, heads, dh).permute(0, 2, 1, 3) for _ in range(3))
            fq, fk, fv = (t.permute(0, 2, 1, 3) for t in qkv.view(bsz_g, T, 3, heads, dh).unbind(2))
            bias = torch.randn(heads, T, T, device="cuda", generator=gen)
            gate = torch.rand(bsz_g, heads, T, device="cuda", generator=gen) + 1.0
            attn_mask = (gate[..., None] * bias[None]).to(dtype)
            bound = attention_bound_ms(name, gated=True, padded=False, seq=T, heads=heads, dim=dh, bsz=bsz_g,
                                       tf32x3=tf32x3)
            flops = 4.0 * bsz_g * heads * T * T * dh
            with torch.no_grad():
                for kname, run, twin, views in (
                    ("gated_bias_attention", lambda: ak.gated_bias_attention(sq, sk, sv, bias, gate),
                     lambda: ak.gated_bias_attention_reference(sq, sk, sv, bias, gate), (sq, sk, sv)),
                    ("fused_qkv_gated_attention", lambda: ak.fused_qkv_gated_attention(qkv, heads, bias, gate),
                     lambda: ak.fused_qkv_gated_reference(qkv, heads, bias, gate), (fq, fk, fv)),
                ):
                    label = f"{kname} dh={dh} H={heads} B={bsz_g} T={T} {name} (gate, {body})"
                    err = forward_held(label, run, twin)
                    if dh in timed:
                        record(kname, dh, name, label, err, run, twin,
                               lambda: F.scaled_dot_product_attention(*views, attn_mask=attn_mask, scale=dh**-0.5),
                               bound, flops, (*views, attn_mask), fp32)
                if fp32:
                    lse_held(f"fused_qkv_gated_attention dh={dh} H={heads} B={bsz_g} T={T} {name}", qkv, heads,
                             None, bias, gate)
            del qkv, sq, sk, sv, fq, fk, fv, attn_mask
            torch.cuda.empty_cache()

            # K3 at BEATs' training shape, with the gate
            qkv = torch.randn(bsz_b3, T, 3 * e, device="cuda", generator=gen).to(dtype).requires_grad_()
            bias = bias.requires_grad_()
            gate = gate[:bsz_b3].clone().requires_grad_()
            dout = torch.randn(bsz_b3, T, e, device="cuda", generator=gen).to(dtype)
            out = ak.fused_qkv_gated_attention(qkv, heads, bias, gate)
            got, bodies = bodies_of(lambda: torch.autograd.grad(out, (qkv, bias, gate), dout, retain_graph=True))
            label = f"fused_qkv_gated_attention_backward dh={dh} H={heads} B={bsz_b3} T={T} {name}"
            check(bodies == {bwd_body: 1}, f"{label}: ran on the {bwd_body} body ({bodies})")
            want = ak.fused_qkv_gated_backward_reference(qkv.detach(), heads, bias.detach(), gate.detach(), None,
                                                         dout)
            err = held(label + " dqkv", dtype, got[0], want[0], tf32x3=fp32)
            held(label + " dbias", dtype, got[1], want[1], sums=True)
            held(label + " dgate", dtype, got[2], want[2], sums=True)
            if dtype == torch.bfloat16:
                *_, saved, rest, lse = out.grad_fn.saved_tensors  # K2's residuals
                own = ak.fused_qkv_backward_from_residuals_reference(qkv.detach(), saved, lse, None, dout,
                                                                     out_rest=rest, pos_bias=bias.detach(),
                                                                     gate=gate.detach())
                for part, g, w in zip(("dqkv", "dbias", "dgate"), got, own):
                    held(f"{label} {part} vs its residual twin", dtype, g, w)
                del own, saved, rest, lse
            del got, want
            if dh in timed:
                q, k, v = (t.detach().permute(0, 2, 1, 3).requires_grad_()
                           for t in qkv.detach().view(bsz_b3, T, 3, heads, dh).unbind(2))
                gated_bias = (gate.detach()[..., None] * bias.detach()[None]).to(dtype).requires_grad_()
                ms = median_ms(lambda: torch.autograd.grad(out, (qkv, bias, gate), dout, retain_graph=True), reps)
                plain_ms = median_ms(lambda: ak.fused_qkv_gated_backward_reference(
                    qkv.detach(), heads, bias.detach(), gate.detach(), None, dout), reps)
                library_ms = sdpa_backward_ms(q, k, v, gated_bias, dout, reps)
                t_bound, bound_by = backward_bound_ms(name, bsz_b3, T, gated=True, padded=False, heads=heads, dim=dh,
                                                      tf32x3=fp32)
                note = fp32_backward_note(ms, bsz_b3, T, heads, dh) if fp32 else ""
                note += backward_quote("K3", dh, ms, q, k, v, gated_bias) if fp32 and twin_bytes is not None else ""
                print(f"time {label} (gate, {bwd_label}): kernel {ms:.4f} ms "
                      f"({tflops(10.0 * bsz_b3 * heads * T * T * dh, ms):.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
                      f"sdpa backward {library_ms:.4f} ms, bound {t_bound:.4f} ms by {bound_by} "
                      f"({t_bound / ms:.1%} of bound){note}; {CARD[0]}")
                results[("fused_qkv_gated_attention_backward", dh, name)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=t_bound,
                    bound_by=bound_by)
                del q, k, v, gated_bias
            del qkv, bias, gate, dout, out
            torch.cuda.empty_cache()

            # K6 at EAT's training shape
            qkv = torch.randn(bsz_b6, T_EAT, 3 * e, device="cuda", generator=gen).to(dtype).requires_grad_()
            dout = torch.randn(bsz_b6, T_EAT, e, device="cuda", generator=gen).to(dtype)
            out = ak.fused_qkv_attention(qkv, heads)
            (got,), bodies = bodies_of(lambda: torch.autograd.grad(out, (qkv,), dout, retain_graph=True))
            label = f"fused_qkv_attention_backward dh={dh} H={heads} B={bsz_b6} T={T_EAT} {name}"
            check(bodies == {bwd_body: 1}, f"{label}: ran on the {bwd_body} body ({bodies})")
            err = held(label, dtype, got, ak.fused_qkv_backward_reference(qkv.detach(), heads, None, dout),
                       tf32x3=fp32)
            if dtype == torch.bfloat16:
                *_, saved, rest, lse = out.grad_fn.saved_tensors  # K5's residuals
                held(label + " vs its residual twin", dtype, got, ak.fused_qkv_backward_from_residuals_reference(
                    qkv.detach(), saved, lse, None, dout, out_rest=rest)[0])
                del saved, rest, lse
            del got
            if dh in timed:
                q, k, v = (t.detach().permute(0, 2, 1, 3).requires_grad_()
                           for t in qkv.detach().view(bsz_b6, T_EAT, 3, heads, dh).unbind(2))
                ms = median_ms(lambda: torch.autograd.grad(out, (qkv,), dout, retain_graph=True), reps)
                plain_ms = median_ms(lambda: ak.fused_qkv_backward_reference(qkv.detach(), heads, None, dout), reps)
                library_ms = sdpa_backward_ms(q, k, v, None, dout, reps)
                t_bound, bound_by = backward_bound_ms(name, bsz_b6, T_EAT, gated=False, padded=False, heads=heads,
                                                      dim=dh, tf32x3=fp32)
                note = fp32_backward_note(ms, bsz_b6, T_EAT, heads, dh) if fp32 else ""
                note += backward_quote("K6", dh, ms, q, k, v, None) if fp32 and twin_bytes is not None else ""
                print(f"time {label} ({bwd_label}): kernel {ms:.4f} ms "
                      f"({tflops(10.0 * bsz_b6 * heads * T_EAT * T_EAT * dh, ms):.1f} TFLOP/s), plain "
                      f"{plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms, bound {t_bound:.4f} ms by {bound_by} "
                      f"({t_bound / ms:.1%} of bound){note}; {CARD[0]}")
                results[("fused_qkv_attention_backward", dh, name)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=t_bound,
                    bound_by=bound_by)
                del q, k, v
            del qkv, dout, out
            torch.cuda.empty_cache()

            # one ragged tile with a key mask: every kernel once
            bsz, seq = HW_RAGGED_B, HW_RAGGED_T
            qkv = torch.randn(bsz, seq, 3 * e, device="cuda", generator=gen).to(dtype)
            q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(bsz, seq, 3, heads, dh).unbind(2))
            bias = torch.randn(heads, seq, seq, device="cuda", generator=gen)
            gate = torch.rand(bsz, heads, seq, device="cuda", generator=gen) + 1.0
            mask = torch.zeros(bsz, seq, dtype=torch.bool, device="cuda")
            mask[1, 20:] = True
            mask[5, 3:] = True
            forward_mask = mask.clone()
            if padded_item:
                forward_mask[7] = True  # every key of item 7 padded: NaN there, as the twin gives
            dout = torch.randn(bsz, seq, e, device="cuda", generator=gen).to(dtype)
            tag = f"dh={dh} B={bsz} T={seq} {name} masked"
            with torch.no_grad():
                forward_held(f"gated_bias_attention {tag}",
                             lambda: ak.gated_bias_attention(q, k, v, bias, gate, forward_mask),
                             lambda: ak.gated_bias_attention_reference(q, k, v, bias, gate, forward_mask))
                forward_held(f"plain_attention {tag}", lambda: ak.gated_bias_attention(q, k, v, None, None, forward_mask),
                             lambda: ak.gated_bias_attention_reference(q, k, v, None, None, forward_mask))
                if padded_item:
                    forward_held(f"fused_qkv_gated_attention {tag}, an item all padded",
                                 lambda: ak.fused_qkv_gated_attention(qkv, heads, bias, gate, forward_mask),
                                 lambda: ak.fused_qkv_gated_reference(qkv, heads, bias, gate, forward_mask))
                    forward_held(f"fused_qkv_attention {tag}, an item all padded",
                                 lambda: ak.fused_qkv_attention(qkv, heads, forward_mask),
                                 lambda: ak.fused_qkv_reference(qkv, heads, forward_mask))
                    if fp32:
                        lse_held(f"fused_qkv_gated_attention {tag}, an item all padded", qkv, heads, forward_mask,
                                 bias, gate)
            leaves = (qkv.clone().requires_grad_(), bias.clone().requires_grad_(), gate.clone().requires_grad_())
            out = ak.fused_qkv_gated_attention(leaves[0], heads, leaves[1], leaves[2], mask)
            held(f"fused_qkv_gated_attention {tag}", dtype, out.detach(),
                 ak.fused_qkv_gated_reference(qkv, heads, bias, gate, mask), tf32x3=tf32x3)
            got, bodies = bodies_of(lambda: torch.autograd.grad(out, leaves, dout))
            check(bodies == {bwd_body: 1}, f"fused_qkv_gated_attention_backward {tag}: ran on the {bwd_body} body "
                                           f"({bodies})")
            want = ak.fused_qkv_gated_backward_reference(qkv, heads, bias, gate, mask, dout)
            for part, g, w in zip(("dqkv", "dbias", "dgate"), got, want):
                held(f"fused_qkv_gated_attention_backward {part} {tag}", dtype, g, w, sums=part != "dqkv",
                     tf32x3=fp32)
            leaf = qkv.clone().requires_grad_()
            out = ak.fused_qkv_attention(leaf, heads, mask)
            held(f"fused_qkv_attention {tag}", dtype, out.detach(), ak.fused_qkv_reference(qkv, heads, mask),
                 tf32x3=tf32x3)
            (got,), bodies = bodies_of(lambda: torch.autograd.grad(out, (leaf,), dout))
            check(bodies == {bwd_body: 1}, f"fused_qkv_attention_backward {tag}: ran on the {bwd_body} body ({bodies})")
            held(f"fused_qkv_attention_backward {tag}", dtype, got,
                 ak.fused_qkv_backward_reference(qkv, heads, mask, dout), tf32x3=fp32)
            del qkv, q, k, v, bias, gate, mask, forward_mask, dout, leaves, out, got, want, leaf
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    counts = read_counts()
    for kname in ("gated_bias_attention", "fused_qkv_gated_attention", "plain_attention", "fused_qkv_attention",
                  "fused_qkv_gated_attention_backward", "fused_qkv_attention_backward"):
        check(counts[kname] > 0, f"phase {phase}: {kname} launched {counts[kname]} times at dh {tuple(widths)}")
    return results, counts, shapes


def phase_head_width_kernels():
    """K1-K6 at dh 16, 32, 96 and 128, E = 768 (48, 24, 8 and 6 heads)
    (``head_width_kernels``, every width timed), then dh 20 and 136 (narrow
    rows, two column chunks) at 2 heads, gated or not, bf16 and fp32,
    against the twins.
    Returns per-kernel numbers by (kernel, dh, dtype) and the phase's
    launches."""
    import torch

    from avex_tpu_torch.ops import attention_kernels as ak

    start = time.perf_counter()
    results, counts, _ = head_width_kernels(34, HW_WIDTHS, HW_WIDTHS, lambda dh: E // dh, seed=34, padded_item=True)
    gen = torch.Generator(device="cuda").manual_seed(340)
    for dh in (20, 136):  # widths past phase 34's rule run too, gated or not
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn(2, 31, 6 * dh, device="cuda", generator=gen).to(dtype)
            q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(2, 31, 3, 2, dh).unbind(2))
            bias = torch.randn(2, 31, 31, device="cuda", generator=gen)
            with torch.no_grad():
                for what, got, want in (
                    ("fused_qkv_attention", ak.fused_qkv_attention(qkv, 2), ak.fused_qkv_reference(qkv, 2)),
                    ("gated_bias_attention", ak.gated_bias_attention(q, k, v, bias),
                     ak.gated_bias_attention_reference(q, k, v, bias)),
                ):
                    ok = torch.isfinite(got).all() and (
                        float((got.float() - want.float()).abs().max()) <= FP32_ATOL if dtype == torch.float32
                        else rel_l2(got, want) <= BF16_REL_L2)
                    check(bool(ok), f"{what} at dh {dh} {dtype} runs on the card and agrees with its twin")
    torch.cuda.synchronize()
    after = read_counts()
    check(after["fused_qkv_attention"] == counts["fused_qkv_attention"] + 4
          and after["gated_bias_attention"] == counts["gated_bias_attention"] + 4,
          "phase 34: dh 20 and 136 launched K5 and K1 four times each")
    print(f"phase 34 kernels: {time.perf_counter() - start:.1f} s; launches "
          f"{ {k: v for k, v in after.items() if v} }")
    return results, after


def phase_head_width_paths(workdir: Path) -> dict:
    """BEATs at dh 128 (768 wide, 12 layers, 6 heads) and EAT at dh 32 (24
    heads) through their entry points, each against the port's plain path
    on the same weights, and the repo's example run config (BEATs, 64 wide,
    4 heads of 16) through ``run_train`` with ``use_pallas`` and
    ``fused_qkv`` set in the call. Returns the launches of every kernel."""
    import torch

    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec

    start = time.perf_counter()
    totals: dict = {}

    def add(counts):
        for kname, count in counts.items():
            totals[kname] = totals.get(kname, 0) + count

    layers = ENCODER_LAYERS
    beats_init = dict(encoder_attention_heads=BEATS_DH128_HEADS)
    n_emb = (layers + 1) * E
    gen = torch.Generator(device="cuda").manual_seed(341)
    batches = [torch.randn(B, CLIP_SAMPLES, device="cuda", generator=gen) * 0.1 for _ in range(2)]

    def mean_pool(features, aux):
        return features.mean(dim=1)

    with torch.no_grad():
        # (a) BEATs dh 128: K1 in bf16; int8 (K1 with K7); fp32 kernel path vs plain path
        model = load_beats("bfloat16", use_pallas=True, **beats_init)
        _, pooled16, counts, rate16 = drive(model, "BEATs dh 128 bf16 split", {"gated_bias_attention": layers},
                                            batches, n_emb, mean_pool)
        add(counts)
        del model
        model = load_beats("bfloat16", quantization="int8", use_pallas=True, **beats_init)
        _, pooled_q, counts, rate_q = drive(model, "BEATs dh 128 int8 bf16",
                                            {"int8_dynamic_dense": INT8_PER_FORWARD, "gated_bias_attention": layers},
                                            batches, n_emb, mean_pool)
        add(counts)
        del model
        rel = rel_l2(pooled_q, pooled16)
        check(rel < INT8_FLOAT_REL, f"BEATs dh 128: int8 vs float bf16, same weights: pooled rel L2 {rel:.3e} < "
                                    f"{INT8_FLOAT_REL:g}")
        small = [b[:B_HW_FP32] for b in batches[:1]]
        model = load_beats("float32", use_pallas=True, **beats_init)
        emb32, pooled32, _, _ = drive(model, "BEATs dh 128 fp32 split", {"gated_bias_attention": layers},
                                      small, n_emb, mean_pool, body="tf32x3")
        del model
        plain = load_beats("float32", use_pallas=False, **beats_init)
        reset_counts()
        ref_pooled = plain(small[0]).float().mean(dim=1)
        ref_emb = plain.extract_embeddings(small[0], aggregation="mean")
        check(sum(read_counts().values()) == 0, "BEATs dh 128 fp32 plain path launches no kernel")
        del plain
        compare_paths("BEATs dh 128", pooled32, emb32, ref_pooled, ref_emb)
    torch.cuda.empty_cache()

    # (b) BEATs dh 128 training with fused_qkv: K2 and K3
    def load_beats_train(dtype, use_pallas):
        spec = ModelSpec(name="beats", pretrained=False, compute_dtype=dtype,
                         init_config=dict(beats_config(), **beats_init, fused_qkv=True, use_pallas=use_pallas))
        return avex_tpu_torch.load_model(spec, random_weights=True, num_classes=N_CLASSES, device="cuda")

    batch = {"raw_wav": torch.randn(B_TRAIN, CLIP_SAMPLES, device="cuda", generator=gen) * 0.1,
             "label": torch.randint(0, N_CLASSES, (B_TRAIN,), device="cuda", generator=gen)}
    expect = {"fused_qkv_gated_attention": layers, "fused_qkv_gated_attention_backward": layers}
    trainer, losses, ms_beats, _, _, counts = train_run("beats", load_beats_train("bfloat16", True), batch, expect,
                                                        TRAIN_STEPS, workdir / "beats")
    add(counts)
    del trainer
    torch.cuda.empty_cache()
    beats_grad = training_gradient_check("BEATs dh 128", load_beats_train, batch["raw_wav"][:B_GRAD_CHECK], expect)

    # (c) EAT dh 32: K5 extraction, K6 training
    def load_eat(dtype, use_pallas, **kwargs):
        return avex_tpu_torch.load_model("esp_aves2_sl_eat_all_ssl_all", random_weights=True, device="cuda",
                                         use_pallas=use_pallas, compute_dtype=dtype, heads=EAT_DH32_HEADS, **kwargs)

    eat_batches = [torch.randn(B, EAT_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1 for _ in range(2)]

    def eat_pool(features, aux):
        return aux["pooled"]

    with torch.no_grad():
        model = load_eat("bfloat16", True, return_features_only=True)
        model.register_hooks_for_layers(["all"])
        _, _, counts, rate_eat = drive(model, "EAT dh 32 bf16", {"fused_qkv_attention": 12}, eat_batches, 12 * E,
                                       eat_pool)
        add(counts)
        del model
        small = [b[:B_HW_FP32] for b in eat_batches[:1]]
        model = load_eat("float32", True, return_features_only=True)
        model.register_hooks_for_layers(["all"])
        emb32, pooled32, _, _ = drive(model, "EAT dh 32 fp32", {"fused_qkv_attention": 12}, small, 12 * E,
                                      eat_pool, body="tf32x3")
        del model
        plain = load_eat("float32", None, return_features_only=True)
        plain.register_hooks_for_layers(["all"])
        reset_counts()
        ref_pooled = eat_pool(*plain.module(small[0], None)).float()
        ref_emb = plain.extract_embeddings(small[0], aggregation="mean")
        check(sum(read_counts().values()) == 0, "EAT dh 32 fp32 plain path launches no kernel")
        del plain
        compare_paths("EAT dh 32", pooled32, emb32, ref_pooled, ref_emb)
    torch.cuda.empty_cache()
    batch = {"raw_wav": torch.randn(B_TRAIN, EAT_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1,
             "label": torch.randint(0, N_CLASSES, (B_TRAIN,), device="cuda", generator=gen)}
    expect = {"fused_qkv_attention": 12, "fused_qkv_attention_backward": 12}
    trainer, losses, ms_eat, _, _, counts = train_run(
        "eat_hf", load_eat("bfloat16", True, num_classes=N_CLASSES), batch, expect, TRAIN_STEPS, workdir / "eat")
    add(counts)
    del trainer
    torch.cuda.empty_cache()
    eat_grad = training_gradient_check("EAT dh 32", reused_paths(lambda dtype: load_eat(dtype, True,
                                                                                       num_classes=N_CLASSES)),
                                       batch["raw_wav"][:B_GRAD_CHECK], expect)

    # (d) the repo's example run config (dh 16) through ``commands.train``, the
    # kernels set in the call's patches
    import yaml

    from avex_tpu_torch import commands

    path = Path(__file__).resolve().parent / EXAMPLE_RUN_CONFIG
    patches = {"model_spec.init_config.use_pallas": "true", "model_spec.init_config.fused_qkv": "true",
               "output_dir": str(workdir / "example_run")}
    data = yaml.safe_load(path.read_text())
    reset_counts()
    result = commands.train(str(path), [f"{key}={value}" for key, value in patches.items()])
    torch.cuda.synchronize()
    counts = read_counts()
    add(counts)
    ex_layers = data["model_spec"]["init_config"]["encoder_layers"]
    bsz = data["training_params"]["batch_size"]
    steps = sum(-(-int(e["train"]["samples"]) // bsz) for e in result["history"])
    val_batches = sum(-(-int(e["val"]["samples"]) // bsz) for e in result["history"])
    losses = [e["train"]["loss"] for e in result["history"]] + [e["val"]["loss"] for e in result["history"]]
    want = {"fused_qkv_gated_attention": ex_layers * (steps + val_batches),
            "fused_qkv_gated_attention_backward": ex_layers * steps}
    check(all(counts[k] == want.get(k, 0) for k in counts),
          f"example run config (dh 16, {ex_layers} layers, {steps} steps, {val_batches} validation batches): "
          f"launches { {k: v for k, v in counts.items() if v} } == {want}")
    check(all(math.isfinite(x) for x in losses), f"example run config: every epoch's loss finite: {losses}")
    print(json.dumps({"phase": 34, "beats_dh128": {"clips_per_s": {"bf16_split_kernel": rate16,
                                                                   "bf16_int8_kernel": rate_q},
                                                   "int8_vs_float_pooled_rel_l2": rel, "train_ms_per_step": ms_beats,
                                                   **beats_grad},
                      "eat_dh32": {"clips_per_s": rate_eat, "train_ms_per_step": ms_eat, **eat_grad},
                      "example_run": {"losses": losses, "steps": steps}, "card": CARD[0]}))
    print(f"phase 34 paths: {time.perf_counter() - start:.1f} s; launches { {k: v for k, v in totals.items() if v} }")
    return totals


# ---------------------------------------------------------------------------
# Phase 35: head widths that are not a multiple of 8, or are above 128
# ---------------------------------------------------------------------------

WH_WIDTHS = (4, 12, 20, 33, 70, 100, 136, 150, 192, 256, 320, 512)
WH_TIMED = (12, 20, 136, 192, 256, 320)  # timed beside the twin, the bound and SDPA
WH_TIMED_LAUNCHES = 10  # the median of 10 calls (not 20), for the script's time
WH_CHECK_B = 16  # the batch of the widths checked and not timed
# A batch is cut where the twin's fp32 [B, H, T, T] logits would pass this
# (192 heads of 4 at T=513: B=45 of 128); every other width keeps phase 34's.
WH_TWIN_BYTES = 9 * 2**30
# full width and depth, only the head count changed: BEATs 4 x 192, EAT 64 x 12, Bird-MAE huge 5 x 256
BEATS_WIDE_HEADS, EAT_NARROW_HEADS, MAE_WIDE_HEADS = 4, 64, 5
B_WH_MAE_FP32 = 8  # Bird-MAE huge's fp32 kernel-vs-plain check


def wide_head_count(dh: int) -> int:
    """Heads at head width dh: E = 768, or the nearest multiple of dh."""
    return max(1, round(E / dh))


def phase_wide_head_kernels():
    """K1-K6 at dh 4, 12, 20, 33, 70, 100, 136, 150, 192, 256, 320 and 512
    (``head_width_kernels``: phase 34's shapes for the timed widths, B=16
    for the rest, E = 768 or the nearest multiple of dh, the batch cut where
    the twin would not fit; a ragged
    masked case a width with an item all padded), the widths of
    :data:`WH_TIMED` timed with SDPA's backend printed; then
    ``general_path_cost``. Returns per-kernel numbers by (kernel, dh,
    dtype) and the phase's launches."""
    start = time.perf_counter()
    results, counts, shapes = head_width_kernels(35, WH_WIDTHS, WH_TIMED, wide_head_count, seed=35,
                                                 twin_bytes=WH_TWIN_BYTES, padded_item=True,
                                                 reps=WH_TIMED_LAUNCHES, check_batch=WH_CHECK_B)
    general_path_cost()
    counts = read_counts()
    print(json.dumps({"phase": 35, "shapes": {f"dh{dh}": v for dh, v in shapes.items()}, "card": CARD[0]}))
    print(f"phase 35 kernels: {time.perf_counter() - start:.1f} s; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    return results, counts


def general_path_cost() -> None:
    """K5 at dh 64, EAT's shape, bf16: the kernel that runs 16-byte rows
    against the general kernel on the same values two bytes off their
    16-byte boundary (narrow rows), each held to the twin; the reason both
    paths stay."""
    import torch

    from avex_tpu_torch.ops import attention_kernels as ak

    gen = torch.Generator(device="cuda").manual_seed(352)
    store = torch.randn(B, T_EAT, 3 * E + 1, device="cuda", generator=gen).to(torch.bfloat16)
    aligned, shifted = store[..., :3 * E].contiguous(), store[..., 1:]
    shifted.copy_(aligned)
    with torch.no_grad():
        want = ak.fused_qkv_reference(aligned, H)
        for what, qkv in (("16-byte rows", aligned), ("narrow rows, 2 bytes off", shifted)):
            got = ak.fused_qkv_attention(qkv, H)
            rel = rel_l2(got, want)
            check(rel <= BF16_REL_L2, f"fused_qkv_attention dh=64 {what}: rel L2 {rel:.3e} <= {BF16_REL_L2:g}")
            ms = median_ms(lambda: ak.fused_qkv_attention(qkv, H), WH_TIMED_LAUNCHES)
            print(f"time fused_qkv_attention dh=64 H={H} B={B} T={T_EAT} bfloat16, {what}: kernel {ms:.4f} ms; "
                  f"{CARD[0]}")


def phase_wide_head_paths(workdir: Path) -> dict:
    """BEATs with 4 heads of 192 (K1 extraction, int8 K1 + K7, the fp32
    kernel path against the plain path, a ``fused_qkv`` training step on
    K2/K3 with the fp32 gradient check), EAT with 64 heads of 12 (K5
    extraction of 10 s clips, K5/K6 training, the same checks) and Bird-MAE
    huge with 5 heads of 256 (K5 extraction of 10 s clips at 32 kHz, the fp32
    kernel path against the plain path), each at full width and depth with
    seeded random weights through its entry point. Returns the launches of
    every kernel."""
    import torch

    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec

    start = time.perf_counter()
    totals: dict = {}

    def add(counts):
        for kname, count in counts.items():
            totals[kname] = totals.get(kname, 0) + count

    layers = ENCODER_LAYERS
    beats_init = dict(encoder_attention_heads=BEATS_WIDE_HEADS)
    n_emb = (layers + 1) * E
    gen = torch.Generator(device="cuda").manual_seed(351)
    batches = [torch.randn(B, CLIP_SAMPLES, device="cuda", generator=gen) * 0.1 for _ in range(2)]

    def mean_pool(features, aux):
        return features.mean(dim=1)

    with torch.no_grad():
        # (a) BEATs 4 x 192: K1 in bf16; int8 (K1 with K7); fp32 kernel path vs plain path
        model = load_beats("bfloat16", use_pallas=True, **beats_init)
        _, pooled16, counts, rate16 = drive(model, "BEATs 4 x 192 bf16 split", {"gated_bias_attention": layers},
                                            batches, n_emb, mean_pool)
        add(counts)
        del model
        model = load_beats("bfloat16", quantization="int8", use_pallas=True, **beats_init)
        _, pooled_q, counts, rate_q = drive(model, "BEATs 4 x 192 int8 bf16",
                                            {"int8_dynamic_dense": INT8_PER_FORWARD, "gated_bias_attention": layers},
                                            batches, n_emb, mean_pool)
        add(counts)
        del model
        rel = rel_l2(pooled_q, pooled16)
        check(rel < INT8_FLOAT_REL, f"BEATs 4 x 192: int8 vs float bf16, same weights: pooled rel L2 {rel:.3e} < "
                                    f"{INT8_FLOAT_REL:g}")
        small = [b[:B_HW_FP32] for b in batches[:1]]
        model = load_beats("float32", use_pallas=True, **beats_init)
        emb32, pooled32, _, _ = drive(model, "BEATs 4 x 192 fp32 split", {"gated_bias_attention": layers},
                                      small, n_emb, mean_pool, body="tf32x3")
        for layer in model.module.backbone.encoder.layers:  # the same weights on the plain path
            layer.self_attn.use_pallas = False
        reset_counts()
        ref_pooled = model(small[0]).float().mean(dim=1)
        ref_emb = model.extract_embeddings(small[0], aggregation="mean")
        check(sum(read_counts().values()) == 0, "BEATs 4 x 192 fp32 plain path launches no kernel")
        del model
        compare_paths("BEATs 4 x 192", pooled32, emb32, ref_pooled, ref_emb)
    torch.cuda.empty_cache()

    # (b) BEATs 4 x 192 training with fused_qkv: K2 and K3
    def load_beats_train(dtype, use_pallas):
        spec = ModelSpec(name="beats", pretrained=False, compute_dtype=dtype,
                         init_config=dict(beats_config(), **beats_init, fused_qkv=True, use_pallas=use_pallas))
        return avex_tpu_torch.load_model(spec, random_weights=True, num_classes=N_CLASSES, device="cuda")

    batch = {"raw_wav": torch.randn(B_TRAIN, CLIP_SAMPLES, device="cuda", generator=gen) * 0.1,
             "label": torch.randint(0, N_CLASSES, (B_TRAIN,), device="cuda", generator=gen)}
    expect = {"fused_qkv_gated_attention": layers, "fused_qkv_gated_attention_backward": layers}
    trainer, _, ms_beats, _, _, counts = train_run("beats", load_beats_train("bfloat16", True), batch, expect,
                                                   TRAIN_STEPS, workdir / "beats")
    add(counts)
    del trainer
    torch.cuda.empty_cache()
    # two column chunks of 96: the wide 3xTF32 forward and backward
    beats_grad = training_gradient_check("BEATs 4 x 192", load_beats_train, batch["raw_wav"][:B_GRAD_CHECK], expect)

    # (c) EAT 64 x 12: K5 extraction, K6 training
    def load_eat(dtype, use_pallas, **kwargs):
        return avex_tpu_torch.load_model("esp_aves2_sl_eat_all_ssl_all", random_weights=True, device="cuda",
                                         use_pallas=use_pallas, compute_dtype=dtype, heads=EAT_NARROW_HEADS,
                                         **kwargs)

    eat_batches = [torch.randn(B, EAT_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1 for _ in range(2)]

    def aux_pool(features, aux):
        return aux["pooled"]

    with torch.no_grad():
        model = load_eat("bfloat16", True, return_features_only=True)
        model.register_hooks_for_layers(["all"])
        _, _, counts, rate_eat = drive(model, "EAT 64 x 12 bf16", {"fused_qkv_attention": 12}, eat_batches, 12 * E,
                                       aux_pool)
        add(counts)
        del model
        small = [b[:B_HW_FP32] for b in eat_batches[:1]]
        model = load_eat("float32", True, return_features_only=True)
        model.register_hooks_for_layers(["all"])
        emb32, pooled32, _, _ = drive(model, "EAT 64 x 12 fp32", {"fused_qkv_attention": 12}, small, 12 * E,
                                      aux_pool, body="tf32x3")
        for block in model.module.blocks:  # the same weights on the plain path
            block.use_pallas = False
        reset_counts()
        ref_pooled = aux_pool(*model.module(small[0], None)).float()
        ref_emb = model.extract_embeddings(small[0], aggregation="mean")
        check(sum(read_counts().values()) == 0, "EAT 64 x 12 fp32 plain path launches no kernel")
        del model
        compare_paths("EAT 64 x 12", pooled32, emb32, ref_pooled, ref_emb)
    torch.cuda.empty_cache()
    batch = {"raw_wav": torch.randn(B_TRAIN, EAT_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1,
             "label": torch.randint(0, N_CLASSES, (B_TRAIN,), device="cuda", generator=gen)}
    expect = {"fused_qkv_attention": 12, "fused_qkv_attention_backward": 12}
    trainer, _, ms_eat, _, _, counts = train_run(
        "eat_hf", load_eat("bfloat16", True, num_classes=N_CLASSES), batch, expect, TRAIN_STEPS, workdir / "eat")
    add(counts)
    del trainer
    torch.cuda.empty_cache()
    eat_grad = training_gradient_check("EAT 64 x 12", reused_paths(lambda dtype: load_eat(dtype, True,
                                                                                           num_classes=N_CLASSES)),
                                       batch["raw_wav"][:B_GRAD_CHECK], expect)  # narrow rows, 3xTF32 K5 and K6

    # (d) Bird-MAE huge 5 x 256: K5 extraction of 10 s clips at 32 kHz, fp32 kernel path vs plain path
    def load_mae(dtype, use_pallas):
        spec = ModelSpec(name="birdmae", pretrained=False, model_id=MAE_HUGE, compute_dtype=dtype,
                         init_config={"use_pallas": use_pallas, "heads": MAE_WIDE_HEADS})
        model = avex_tpu_torch.load_model(spec, random_weights=True, device="cuda", return_features_only=True)
        model.register_hooks_for_layers(["all"])
        return model

    mae_batches = [torch.randn(B, MAE_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1 for _ in range(2)]
    with torch.no_grad():
        model = load_mae("bfloat16", True)
        blocks = model.module.blocks
        check((len(blocks), blocks[0].dim, blocks[0].heads) == (MAE_LAYERS, E_MAE, MAE_WIDE_HEADS),
              f"Bird-MAE huge 5 x 256: (blocks, dim, heads) {(len(blocks), blocks[0].dim, blocks[0].heads)} == "
              f"{(MAE_LAYERS, E_MAE, MAE_WIDE_HEADS)}")
        _, _, counts, rate_mae = drive(model, "Bird-MAE huge 5 x 256 bf16", {"fused_qkv_attention": MAE_LAYERS},
                                       mae_batches, MAE_LAYERS * E_MAE, aux_pool)
        add(counts)
        del model
        torch.cuda.empty_cache()
        small = [mae_batches[0][:B_WH_MAE_FP32]]
        model = load_mae("float32", True)
        _, pooled32, _, _ = drive(model, f"Bird-MAE huge 5 x 256 fp32 (B={B_WH_MAE_FP32})",
                                  {"fused_qkv_attention": MAE_LAYERS}, small, MAE_LAYERS * E_MAE, aux_pool,
                                  body="tf32x3")
        layers32 = model.extract_embeddings(small[0], aggregation="none")
        for block in model.module.blocks:  # the same weights on the plain path
            block.use_pallas = False
        reset_counts()
        ref_pooled = model.module(small[0])[1]["pooled"].float()
        ref_layers = model.extract_embeddings(small[0], aggregation="none")
        check(sum(read_counts().values()) == 0, "Bird-MAE huge 5 x 256 fp32 plain path launches no kernel")
        del model
        rp = rel_l2(pooled32, ref_pooled)
        layer_rel = [rel_l2(a, b) for a, b in zip(layers32, ref_layers)]
        check(len(layer_rel) == MAE_LAYERS and rp <= PATH_REL and max(layer_rel) <= PATH_REL,
              f"Bird-MAE huge 5 x 256: fp32 kernel path vs plain path (B={B_WH_MAE_FP32}): pooled rel {rp:.3e}, "
              f"worst of {len(layer_rel)} tapped layers rel {max(layer_rel):.3e} <= {PATH_REL:g}")
        del layers32, ref_layers
    torch.cuda.empty_cache()
    print(json.dumps({"phase": 35, "beats_4x192": {"clips_per_s": {"bf16_split_kernel": rate16,
                                                                   "bf16_int8_kernel": rate_q},
                                                   "int8_vs_float_pooled_rel_l2": rel, "train_ms_per_step": ms_beats,
                                                   **beats_grad},
                      "eat_64x12": {"clips_per_s": rate_eat, "train_ms_per_step": ms_eat, **eat_grad},
                      "birdmae_huge_5x256": {"clips_per_s": rate_mae, "fp32_kernel_vs_plain": {
                          "pooled_rel": rp, "worst_layer_rel": max(layer_rel)}},
                      "card": CARD[0]}))
    print(f"phase 35 paths: {time.perf_counter() - start:.1f} s; launches { {k: v for k, v in totals.items() if v} }")
    return totals


def main() -> int:
    start = time.perf_counter()
    phase_card()
    import torch

    timed(phase_build)
    timings = timed(phase_kernels)
    plain_timings, k4_launches = timed(phase_bias_free_kernels)
    k7, k8, k8_launches = timed(phase_int8_kernels)
    backward_timings = timed(phase_backward_kernels)
    k3_long = timed(phase_k3_long)
    dh80_timings, dh80_k4_launches = timed(phase_dh80_kernels)
    ssl_timings = timed(phase_eat_ssl_kernels)
    hw_timings, hw_kernel_counts = timed(phase_head_width_kernels)
    wh_timings, wh_kernel_counts = timed(phase_wide_head_kernels)
    launches = timed(phase_main_path)
    launches["int8_dynamic_dense"] = timed(phase_int8_main_path)
    eat_launches = timed(phase_eat)
    aves_launches = timed(phase_aves)
    birdmae_launches = timed(phase_birdmae)
    atst_launches = timed(phase_atst)
    timed(phase_efficientnet)
    timed(phase_perch)
    timed(phase_resnet)
    timed(phase_serving)
    workdir = Path(__file__).resolve().parent / "build" / "chip_smoke_training"
    beats_train = timed(phase_beats_training, workdir / "beats")
    long_step = timed(phase_beats_long_step)
    eat_train = timed(phase_eat_training, workdir / "eat")
    aves_train = timed(phase_aves_training, workdir / "aves")
    birdmae_train = timed(phase_birdmae_training, workdir / "birdmae")
    atst_train = timed(phase_atst_training, workdir / "atst")
    timed(phase_efficientnet_training, workdir / "efficientnet")
    ssl_train = timed(phase_eat_ssl_training, workdir / "eat_ssl")
    timed(phase_clip, workdir / "clip")
    dots_train = timed(phase_beats_dots, workdir / "dots")
    probes = timed(phase_probes)
    entry = timed(phase_entry_points, Path(__file__).resolve().parent / "build" / "chip_smoke_entry")
    ranks_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_ranks"
    data_parallel = timed(phase_data_parallel, ranks_dir)
    model_parallel = timed(phase_model_parallel, ranks_dir)
    model_axis_rest = timed(phase_model_axis_rest, ranks_dir)
    cli = timed(phase_cli, Path(__file__).resolve().parent / "build" / "chip_smoke_cli")
    head_widths = timed(phase_head_width_paths,
                        Path(__file__).resolve().parent / "build" / "chip_smoke_head_widths")
    wide_heads = timed(phase_wide_head_paths, Path(__file__).resolve().parent / "build" / "chip_smoke_wide_heads")
    torch.cuda.synchronize()
    print(f"fused_qkv_attention (K5) launched {eat_launches} times on the EAT path, {aves_launches} on the AVES "
          f"path, {birdmae_launches} on the Bird-MAE path (huge dh 80, base dh 64) and {atst_launches} on the ATST path")
    launches["fused_qkv_attention"] = eat_launches + aves_launches + birdmae_launches + atst_launches
    # Training: K2/K3 on the BEATs runs (plain, and remat "dots"), K5/K6 on the EAT, AVES,
    # Bird-MAE huge, ATST and EAT-SSL runs.
    for counts in (beats_train, eat_train, aves_train, birdmae_train, atst_train, ssl_train, dots_train):
        for kname in ("fused_qkv_gated_attention", "fused_qkv_attention"):
            launches[kname] += counts[kname]
    launches["fused_qkv_gated_attention_backward"] = (beats_train["fused_qkv_gated_attention_backward"]
                                                      + dots_train["fused_qkv_gated_attention_backward"])
    print(f"EAT-SSL training launches: { {k: v for k, v in ssl_train.items() if v} }; BEATs remat 'dots': "
          f"{ {k: v for k, v in dots_train.items() if v} }")
    # The fp32 BEATs step on 16 s clips: K2 and K3 past T=512.
    for kname in ("fused_qkv_gated_attention", "fused_qkv_gated_attention_backward"):
        launches[kname] += long_step.get(kname, 0)
    print(f"fp32 BEATs step on 16 s clips: launches {long_step}")
    launches["fused_qkv_attention_backward"] = sum(
        counts["fused_qkv_attention_backward"] for counts in (eat_train, aves_train, birdmae_train, atst_train, ssl_train))
    # Probes: K5 on the EAT probes, K1 on the frozen BEATs probes, K2/K3 on the unfrozen one.
    for kname, count in probes.items():
        if count:  # each probe run checked the rest at 0
            launches[kname] += count
    print(f"probes phase launches: { {k: v for k, v in probes.items() if v} }")
    # Entry points: K2/K3 in run_train, K1 in run_evaluate.
    for kname, count in entry.items():
        if count:  # each run checked the rest at 0
            launches[kname] += count
    print(f"entry points phase launches: { {k: v for k, v in entry.items() if v} }")
    # Data parallelism: K2/K3 on the ranks' BEATs steps, K5/K6 on their EAT-SSL steps.
    for kname, count in data_parallel.items():
        if count:  # each rank checked the rest at 0
            launches[kname] += count
    # The model axis: K2/K3 on the ranks' BEATs steps, K5/K6 on their EAT pipeline;
    # phase 32: K5/K6 on Bird-MAE's pipeline and SP, K2/K3 on the 3-D cell (the ring launches none).
    for counts in (model_parallel, model_axis_rest):
        for kname, count in counts.items():
            if count:  # each rank checked the rest at 0
                launches[kname] += count
    # Phase 33: K1, K2 and K5 through embed, K2/K3 through run_train on the checkpointable loader
    # (the serve child's K1/K7 launches are its own process's).
    for kname, count in cli.items():
        if count:  # each run checked the rest at 0
            launches[kname] += count
    # Phase 34: K1 (and K7) on BEATs dh 128, K2/K3 on its training and the example run config (dh 16),
    # K5/K6 on EAT dh 32.
    for kname, count in head_widths.items():
        if count:  # each run checked the rest at 0
            launches[kname] += count
    # Phase 35: K1 (and K7) on BEATs 4 x 192, K2/K3 on its training, K5/K6 on EAT 64 x 12, K5 on
    # Bird-MAE huge 5 x 256.
    for kname, count in wide_heads.items():
        if count:  # each run checked the rest at 0
            launches[kname] += count
    # No main path reaches K4 (every model's projection, dh 64 or Bird-MAE
    # large and huge's 80, takes K5, and K4 takes the same widths) or K8 (in
    # JAX only scripts/bench_int8_matmul.py calls it); drive() checks that each
    # main-path run launched them 0 times. Their kernel-phase launches go
    # under a key of their own.
    launches["plain_attention"] = launches["int8_matmul"] = 0
    kernel_phase = {"plain_attention": k4_launches + dh80_k4_launches + hw_kernel_counts["plain_attention"]
                    + wh_kernel_counts["plain_attention"], "int8_matmul": k8_launches}
    # The bias-free kernels at head width 80 (Bird-MAE huge's shapes), bf16 and fp32.
    dh80 = {kname: {name: dh80_timings[(kname, name)] for name in ("bfloat16", "float32")}
            for kname in ("plain_attention", "fused_qkv_attention", "fused_qkv_attention_backward")}

    tensor_core = "avex_tpu_torch/ops/csrc/tensor_core_attention.cu"  # bf16
    tf32x3 = "avex_tpu_torch/ops/csrc/tf32x3_attention.cu"  # fp32 K1-K6 at every width
    int8 = "avex_tpu_torch/ops/csrc/int8_dense.cu"
    # (kernel, source, line of the TPU kernel, timing at the main path's shape and compute dtype, bf16)
    rows = (
        ("gated_bias_attention", tensor_core, "avex_tpu/ops/pallas_attention.py:126",
         timings[("gated_bias_attention", "bfloat16")]),
        ("fused_qkv_gated_attention", tensor_core, "avex_tpu/ops/pallas_attention.py:389",
         timings[("fused_qkv_gated_attention", "bfloat16")]),
        ("plain_attention", tensor_core, "avex_tpu/ops/pallas_attention.py:161",
         plain_timings[("plain_attention", "EAT", "bfloat16")]),
        ("fused_qkv_attention", tensor_core, "avex_tpu/ops/pallas_attention.py:344",
         plain_timings[("fused_qkv_attention", "EAT", "bfloat16")]),
        ("int8_dynamic_dense", int8, "avex_tpu/ops/pallas_int8.py:100", k7),
        ("int8_matmul", int8, "avex_tpu/ops/pallas_int8.py:46", k8),
        ("fused_qkv_gated_attention_backward", tensor_core, "avex_tpu/ops/pallas_attention.py:765",
         backward_timings[("fused_qkv_gated_attention_backward", "bfloat16")]),
        ("fused_qkv_attention_backward", tensor_core, "avex_tpu/ops/pallas_attention.py:524",
         backward_timings[("fused_qkv_attention_backward", "EAT", "bfloat16")]),
    )
    kernels = []
    for kname, source, replaces, t in rows:
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
        if source == tensor_core and kname.endswith("_backward"):
            kernels[-1]["body"] = {"bf16": "tensor cores (mma.sync bf16)",
                                   "fp32": "tensor cores (mma.sync TF32, 3xTF32) at every head width: 16-byte rows "
                                           "up to 128, narrow rows, column chunks past 128"}
            kernels[-1]["fp32_source"] = tf32x3
            # the fp32 call at the same shape
            kernels[-1]["fp32"] = backward_timings[(kname, "float32") if kname.startswith("fused_qkv_gated")
                                                   else (kname, "EAT", "float32")]
            # the main paths' fp32 gradient checks (``step_gradients``): their launches on the 3xTF32 kernels
            kernels[-1]["fp32_tf32x3_launches"] = TF32X3_STEP_LAUNCHES[kname]
            check(TF32X3_STEP_LAUNCHES[kname] > 0, f"{kname}: the fp32 training steps ran the 3xTF32 kernels "
                                                   f"({TF32X3_STEP_LAUNCHES[kname]} launches)")
        elif source == tensor_core:
            kernels[-1]["body"] = {"bf16": "tensor cores (mma.sync)",
                                   "fp32": "tensor cores (mma.sync TF32, 3xTF32) at every head width: 16-byte rows "
                                           "up to 128, narrow rows, column chunks past 128"}
            kernels[-1]["fp32_source"] = tf32x3
            # the fp32 call at the same shape, with SDPA's backend
            kernels[-1]["fp32"] = timings.get((kname, "float32")) or plain_timings[(kname, "EAT", "float32")]
            # the main paths' fp32 runs (``drive``, ``step_gradients``): their launches on the 3xTF32 kernel
            kernels[-1]["fp32_tf32x3_launches"] = TF32X3_FORWARD_LAUNCHES[kname]
            if kname != "plain_attention":  # no main path reaches K4
                check(TF32X3_FORWARD_LAUNCHES[kname] > 0, f"{kname}: the main paths' fp32 runs launched the 3xTF32 "
                                                          f"forward ({TF32X3_FORWARD_LAUNCHES[kname]} launches)")
        elif kname == "int8_dynamic_dense":
            kernels[-1]["body"] = "row quantization, then wgmma on TMA-fed tiles"
        if kname in dh80:
            kernels[-1]["head_dim_80"] = dh80[kname]
        if kname == "fused_qkv_gated_attention_backward":
            kernels[-1]["fp32_past_512"] = k3_long
        if kname in ("fused_qkv_attention", "fused_qkv_attention_backward"):
            # EAT-SSL's shapes (B=64): student T=103 H=12, decoder T=512 H=6, teacher T=512 H=12 (no grad)
            kernels[-1]["eat_ssl"] = {f"{shape}_{name}": t for (k, shape, name), t in ssl_timings.items()
                                      if k == kname}
            kernels[-1]["eat_ssl_launches"] = ssl_train[kname]
        if data_parallel.get(kname):
            kernels[-1]["data_parallel_launches"] = data_parallel[kname]  # phase 30's share of ``launches``
        if model_parallel.get(kname):
            kernels[-1]["model_parallel_launches"] = model_parallel[kname]  # phase 31's share of ``launches``
        if model_axis_rest.get(kname):
            kernels[-1]["model_axis_rest_launches"] = model_axis_rest[kname]  # phase 32's share
        if cli.get(kname):
            kernels[-1]["cli_launches"] = cli[kname]  # phase 33's share
        if source == tensor_core:
            # phase 34: dh 16, 32, 96, 128 at E = 768, bf16 (tensor cores) and fp32 (3xTF32)
            kernels[-1]["head_widths"] = {f"dh{dh}": {name: hw_timings[(kname, dh, name)]
                                                      for name in ("bfloat16", "float32")} for dh in HW_WIDTHS}
            kernels[-1]["head_width_kernel_phase_launches"] = hw_kernel_counts[kname]
            # phase 35: the widths of WH_TIMED, bf16 (tensor cores) and fp32 (3xTF32: narrow rows, column
            # chunks), at the shapes it prints
            kernels[-1]["wide_head_widths"] = {f"dh{dh}": {name: wh_timings[(kname, dh, name)]
                                                           for name in ("bfloat16", "float32")} for dh in WH_TIMED}
            kernels[-1]["wide_head_kernel_phase_launches"] = wh_kernel_counts[kname]
        if head_widths.get(kname):
            kernels[-1]["head_width_launches"] = head_widths[kname]  # phase 34's share of ``launches``
        if wide_heads.get(kname):
            kernels[-1]["wide_head_launches"] = wide_heads[kname]  # phase 35's share of ``launches``
        if kname in kernel_phase:
            kernels[-1]["kernel_phase_launches"] = kernel_phase[kname]
            check(kernel_phase[kname] > 0, f"{kname} ran in the kernel phase (no main path reaches it)")
        else:
            check(launches[kname] > 0, f"{kname} ran on the main path")
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s, kernel build included; seconds a phase: "
          f"{json.dumps(PHASE_SECONDS)}")
    if FAILURES:
        print(f"{len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
