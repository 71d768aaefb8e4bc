#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

Drives the port's main paths — the paged decode server, the
transformer-LM training step, ResNet-50 training (eager steps, the
captured step and ``fit``), the Module path in fp32 and under AMP,
``FeedForward``, a ``Custom`` op head and the profiler (phases 24-26),
ResNet-50 inference through the Predictor,
the same deployment loaded from a checkpoint, user CUDA C compiled
at run time by ``rtc.Rtc``, the image-classification zoo (Inception-v3
training, AlexNet through ``Module``, a nine-model inference sweep) and
the LSTM language model (``FusedTrainer`` and ``BucketingModule``), and
the detection zoo (SSD-VGG16-300 training and detection, Faster
R-CNN's Proposal -> ROIPooling, LSTM-OCR over WarpCTC), MXNet from
C (the predict ABI, the general C API from C++, the native runtime),
and MXNet's parameter-server training (``dist_sync``/``dist_async``
under the port's launcher) — and holds each
hand-written CUDA kernel
(and each user kernel pushed) against its plain PyTorch version:

1. device: the card's name and power limit, torch/CUDA versions, and
   the build of every kernel from the sources in this checkout (one
   nvcc per source, all started together);
2. kernel checks, each with times of the kernel, its plain version, one
   PyTorch library call as a yardstick the port never calls
   (``scaled_dot_product_attention``) and the least time the card could
   take (bound):
   - ``ops/paged_attention.py`` at the serving shapes, fp32 and bf16
     (two calls bit-identical; its split and combine kernels' device
     time from torch.profiler beside the events time);
   - ``ops/flash_attention.py``'s forward, dQ and dK/dV kernels at the
     training shape (B 8, H 16, T 1024, D 128), fp32 and bf16, causal
     and not (in bf16, a dK/dV without one query tile and a dQ without
     one key tile must fail the per-tile check);
3. full-width serving over HTTP: the repo's largest LM config
   (``MFU_HEADLINE_CONFIG``: 8 layers, d_model 2048, vocab 32768) with
   seeded random bf16 weights, ``serve_decoder(num_slots=8, paged=True,
   kv_block=16)``, 16 concurrent greedy ``POST /generate`` requests;
4. teacher-forced serving parity: the paged backend with the kernel
   against the same backend pinned to the plain gather path, logits at
   every emission, fp32 and bf16;
5. full-width training: ``FusedTrainer`` over ``transformer_lm(
   **MFU_HEADLINE_CONFIG)`` with Adam (lr 1e-4) in bf16 with fp32
   masters, batch 8 x 1024 tokens: one step against the same step with
   the attention pinned to the dense path (``impl="lax"``) from the same
   weights, then timed steps on one repeated batch (tokens/s, step ms,
   MFU, falling cross-entropy, 8 launches of each flash kernel per
   step), peak memory and a device-time profile;
5b. ResNet-50 training at full width (``phase_train_resnet``,
   bench.py:1985-2077): ``models.get_symbol("resnet-50")`` through
   ``FusedTrainer`` with SGD (lr 0.1, momentum 0.9, rescale_grad 1/32)
   in bf16 with fp32 masters at batch 32 x 3 x 224 x 224: ``step_multi``
   (one captured CUDA graph a step) against ``step()`` from the same
   state in fp32 and bf16, one fp32 step channels-last against
   ``MXTPU_CONV_LAYOUT=NCHW``, 60 timed steps through ``step()`` and 56
   through ``step_multi(k=8)`` (images/s, MFU, a profile of each route:
   device time by kind, idle share, host launch calls per step), a
   falling cross-entropy over one repeated batch, and one epoch of
   ``fit`` over an ``NDArrayIter`` of 8 host batches with ``Accuracy``
   and a ``Speedometer``, whose host syncs per batch must be 0; the
   ``[train_resnet]`` line carries bench.py's keys;
5c. the Module path at full width (``phase_module_resnet``, the fp32
   half of bench.py:1692-1776): ``Module`` over ResNet-50 with Xavier
   weights and SGD (lr 0.05, momentum 0.9): at batch 32 one Module step
   against ``FusedTrainer.step`` and the bucketed kvstore update
   (``kvstore=mx.kv.create("local")``) against the eager ``Updater``;
   at batch 256 (TF32 off) 12 timed steps of each route (images/s, step
   ms, peak memory, a profile with the update's own launch calls); one
   epoch of ``Module.fit`` over 8 host batches with ``do_checkpoint``
   (0 host syncs per batch); ``Module.score`` with 4 epilogue launches a
   forward and ``Module.predict`` equal to the Predictor's; and
   ``Module.load(..., load_optimizer_states=True)`` taking the same next
   step as the module that wrote the checkpoint;
5d. the AMP half of ``_amp_micro`` (``phase_module_amp``): the same
   Module cell under ``MXTPU_AMP=bf16`` and ``MXTPU_LOSS_SCALE=dynamic``
   (the ``amp_cast`` graph, 106 Cast nodes, the loss scale at the
   backward): at batch 32 the bucketed update against the eager
   ``Updater`` identical to the bit, then an ``inf`` in one gradient
   that its bucket's weights and momenta survive to the bit, with the
   scale halved and one overflow and one skip reported; at batch 256 12
   timed steps of each route under ``set_sync_debug_mode("error")`` with
   no read of the scaler (images/s, MFU against the bf16 peak, a
   profile beside the fp32 phase's); ``Module.score`` with 4 epilogue
   launches a forward on bf16 inputs, each held against the plain
   version;
6. ResNet-50 inference (``phase_predict``): ``models.resnet.get_symbol(
   1000, 50, (3, 224, 224))`` with seeded random weights through
   ``predict.Predictor`` at batch 32 (the Conv+BN fold and the graph
   passes on, fp32 and bf16): the residual-epilogue kernel against its
   plain version at the four fused tails' shapes, parity of the
   Predictor against the same graph with the four epilogues pinned to
   ``impl="lax"`` and against the passes turned off, images/s over 20
   calls of ``forward`` + ``get_output`` with 4 kernel launches per
   forward, and a device-time profile with peak memory;
7. checkpoints (``phase_checkpoint``): the same ResNet-50 (with a second
   head on the logits) written by ``model.save_checkpoint`` (about 102
   MB of fp32) and loaded back by ``predict.create`` and by
   ``Predictor(param_bytes=...)``, fp32 and bf16: logits identical to
   the Predictor built from the in-memory params, 4 epilogue launches
   per forward, save and load seconds;
8. runtime-compiled user CUDA C (``phase_rtc``): three kernels built by
   ``rtc.Rtc`` through NVRTC and pushed with their grid and block —
   MXNet's own docstring example (``expf`` over 10 values staged in
   shared memory), a grid-stride ``2x + y`` over a vector of the
   ResNet-50 parameter count, and a row softmax over the (32, 1000)
   logits of phase 7 — each against its plain PyTorch twin, with compile
   ms, the compile cache, NVRTC's log on bad source, and µs per push;
9. Inception-v3 training at full width (``phase_train_inception``,
   tools/bench_models.py:46-67): ``models.get_symbol("inception-v3")``
   through ``FusedTrainer`` (SGD lr 0.1, momentum 0.9, bf16 with fp32
   masters) at batch 32 x 3 x 299 x 299: ``step_multi(8)`` against 8
   ``step()`` calls in fp32 and bf16, 24 timed steps through each route
   (images/s, MFU from the graph's conv and FC shapes, a profile with
   device ms by kind, ``cat`` copies and layout converters among them),
   a falling cross-entropy over one repeated batch;
10. AlexNet through ``Module`` (``phase_module_alexnet``,
   BASELINE.md:44-55): batch 256, Xavier, SGD lr 0.01 momentum 0.9,
   fp32, LRN and Dropout on the card in training through the eager
   ``Updater`` and the bucketed update (images/s, a profile, a falling
   loss); ``nd.Dropout`` at (256, 4096) by statistics and by seed; a
   draw on the card after a deliberately failed capture;
11. the inference sweep of tools/benchmark_score.py (``phase_zoo_score``):
   nine models through the ``Predictor`` at batch 32, fp32 and bf16,
   images/s over 20 calls with busy time and idle share, batch-2 fp32
   logits against the port on the CPU, and every epilogue launch of the
   timed calls (resnet-50, resnet-152, resnext-50: 4 a forward) held
   against its plain version;
12. the LSTM language model through ``FusedTrainer``
   (``phase_train_lstm``, tools/bench_models.py:70-102):
   ``models.lstm.get_symbol`` (2 x 200, vocab 10000, dropout 0.2) at
   batch 32 x 35 in bf16 with fp32 masters, SGD lr 1.0: ``step_multi(8)``
   against 8 ``step()`` calls from one generator state on the dropout=0
   graph (fp32, bf16) and the dropout graph, the dropout graph captured
   with its masks fresh a replay and a keep rate within 4 sigma of 0.8,
   24 timed steps through each route with a profile (tokens/s, launch
   calls, device ms by kind, idle share), a falling cross-entropy, and a
   ``FusedRNNCell`` 2 x 200 against the unrolled ``LSTMCell`` stack it
   unpacks into;
13. ``examples/rnn/lstm_bucketing.py``'s loop (``phase_bucketing_lstm``):
   ``BucketingModule.fit`` over ``BucketSentenceIter`` on the example's
   Zipf corpus at vocab 10000, buckets 8/16/24/32, batch 32, 2 x 200,
   dropout 0.2, fp32, with ``compile_buckets`` on and off: two epochs
   each, real tokens/s, executors bound, 0 host syncs per batch, a
   falling perplexity, a profile.  Neither phase launches a hand-written
   kernel (their counts are read around them and stay 0);
14. RecordIO (``phase_records``): the host's cores, Pillow and libjpeg,
   then 2,560 training and 640 val records (256 x 341 JPEG q90, label
   ``i % 1000``, a pattern a class plus noise) through
   ``recordio.MXIndexedRecordIO`` and ``pack_img``;
15. the iterators alone (``phase_record_iter``): ``ImageRecordIter`` at
   1, 4 and all cores' threads and ``MultiProcessImageRecordIter`` with
   4 workers, at batch 32 x 3 x 224 x 224 with ``rand_crop`` and
   ``rand_mirror``, bare and as ``-> PrefetchingIter ->
   DevicePrefetchIter``, images/s with a sum on the card as the
   consumer; every 5th staged batch's fp64 sum on the card equal to its
   host buffer's to the bit; one thread's time a batch by stage;
16. ``train_imagenet.py --fused 1`` (``phase_train_records``): ResNet-50
   bf16 through ``FusedTrainer`` fed from the records, by ``fit`` (2
   epochs) and by ``step_multi(8)`` over ``io.step_multi_feeds`` (1
   epoch; then 1 more fed by 4 ``mp_io`` workers), beside the captured
   step on device-resident data: images/s,
   step ms, idle share, ms a batch waiting on the iterator, host syncs
   a batch (0), a falling cross-entropy;
17. ``train_imagenet.py --fused 0`` and ``score.py``
   (``phase_module_records``): ``Module.fit`` fp32 with
   ``kvstore="device"`` over the records, a second fit with
   ``Monitor(20, ".*weight")`` (rows and host reads on its windows
   only), and score.py's forward-only sweep over the val records with
   4 epilogue launches a forward, each held against the plain version;
18. ``examples/module/sequential_module.py``'s chain through
   ``SequentialModule.fit`` and ``train_mnist.py``'s MLP through
   ``Module.fit`` over ``MNISTIter`` on seeded idx files of MNIST's
   shape (``phase_sequential``).  Phases 14-18 launch the epilogue
   kernel in the score sweeps only (their counts are read around them);
19. ``examples/recommenders/sparse_mf.py`` (``phase_sparse_mf``): its
   model and loop through ``Module.fit`` at its own sizes (20000 users,
   8000 items, rank 8, batch 256, Adam lr 0.05, ``Normal(0.1)``, 40000
   samples, 2 epochs), fp32 and under ``MXTPU_AMP=bf16`` with dynamic
   loss scaling: rmse by epoch (falling), both tables' gradient holders
   row-sparse, touched rows a batch, 0 host syncs a batch, samples/s;
20. ``_sparse_micro``'s kvstore step (``phase_sparse_update``, Adam,
   rescale 1/lookups) sparse and dense at 300000 x 64 and 10,000,000 x
   64 with 4096 lookups: µs a step, speedup, touched fraction and rows/s,
   each side's bound, the sparse pushes under
   ``set_sync_debug_mode("error")``, the small table's result equal to
   the same pushes on the CPU.  Phases 19-20 launch no hand-written
   kernel;
21. the survival layer (``phase_survival``): ResNet-50 bf16 batch 32
   through ``FusedTrainer``, ``_survival_micro``'s keys (40 plain steps,
   40 with ``save_state(background=True)`` every 10, a synchronous
   write, a restore into a fresh trainer, the state's bytes), the next
   step from the restored state equal to the saving trainer's under
   ``torch.use_deterministic_algorithms``, and ``predict.create`` from
   the resumed trainer's checkpoint identical to the saving trainer's
   Predictor with its 4 epilogue launches each held against the plain
   version; the micro-bench's FC net alike;
22. kill and resume (``phase_kill_resume``): ``train_mnist.py``'s MLP
   through ``Module.fit`` with ``MXTPU_CKPT_DIR``/``MXTPU_CKPT_EVERY`` in
   child processes on the card: a SIGKILL after a published checkpoint,
   a resumed child equal to an uninterrupted one to the bit, a SIGTERM
   that leaves a boundary checkpoint and ``Preempted``;
23. recompute (``phase_remat``, run right after phase 5, on the same
   cell): ``transformer_lm(**MFU_HEADLINE_CONFIG)``
   bf16 with ``remat=False`` and ``remat=True``, eager and
   ``step_multi(8)``: peak memory, step ms, tokens/s, flash launches a
   step (16 forwards under remat), one step's agreement, and with
   ``dropout=0.1`` the recompute replaying the forward's masks;
24. ``mx.model.FeedForward`` (``phase_feedforward``, run right after
   phase 5d, with phase 25) over ResNet-50 at ``phase_module_resnet``'s
   cell (batch 256, fp32 with TF32 off, SGD lr 0.05 momentum 0.9,
   seeded He-normal weights): ``fit`` over 2 + 10
   device-resident batches (images/s, 0 host syncs a batch), one epoch
   from numpy arrays (``numpy_batch_size`` 256, the last partial batch
   discarded), ``score`` and ``predict`` over 2 batches with 4 epilogue
   launches a forward each held against the plain version, ``save`` ->
   ``FeedForward.load`` -> ``predict`` identical, and one step through
   ``executor_manager.DataParallelExecutorManager`` equal to Module's;
25. the ``Custom`` op (``phase_custom_op``): the same net with
   examples/numpy-ops/custom_softmax.py's numpy softmax as its head
   through ``FeedForward.fit``: step ms against the SoftmaxOutput head,
   the op's host syncs (one each way) and host ms a batch, one step's
   parameter gradients against SoftmaxOutput's, and
   ``FusedTrainer.step_multi`` refusing the graph;
26. the profiler (``phase_profiler``, run right after phase 23): the LM
   step of phase 5 eagerly,
   3 steps with the profiler off and 3 under ``profiler_set_config(
   mode="symbolic", xla_trace_dir=...)``: step ms both ways, the
   ``forward_backward`` spans, the sizes of ``profile.json`` and of the
   torch.profiler device trace, the flash kernels named in the trace
   (each launch of the first profiled step held against the plain
   version) and the step's elementwise device time by kernel, the ten
   largest; then ``nd`` ops under ``mode="all"`` and their
   ``imperative`` spans;
27. int8 serving (``phase_serve_int8``): the served LM with int8 weights
   (``KVDecoder(quantize="int8")``, bf16 compute) behind
   ``serve_decoder(paged=True)``: weight bytes on the card against the
   bf16 decoder's, 16 requests (tokens/s, TTFT, tick ms, idle share),
   the paged kernel's logits against the gather path on the same int8
   state, and the share of greedy tokens equal to the bf16 decoder's;
28. generation loops (``phase_generate``): ``generate_scan`` greedy at
   batch 8 x 256 new tokens against ``generate`` (token-equal, host
   syncs counted, tokens/s both ways), an eos run that exits early, and
   ``beam_search(beam_size=4)`` at batch 2 x 64;
29. the replica router (``phase_router``): two full-width bf16 replicas
   on the card behind ``start_router``, 64 requests spread over both and
   token-equal to a reference scheduler on the same weights, a drain
   and an undrain, one replica shut down mid-traffic (its requests
   re-route, ``router_retries_total`` counts them), router-added latency
   against direct requests;
30. int8 inference (``phase_predict_int8``): ResNet-50 at batch 32
   through ``Predictor(quantize="int8")`` and ``MXTPU_PREDICT_INT8=1``,
   images/s beside fp32 and bf16 in the same run, top-1 agreement with
   fp32, 4 epilogue launches a forward held against the epilogues
   pinned to the plain version, ``output_index`` and
   ``partial_forward`` once each, and a 4-deep ``forward_async``
   pipeline equal to ``forward``;
31. SSD training (``phase_ssd_train``, examples/ssd/train.py's executor
   loop): ``ssd.get_symbol_train(num_classes=20)`` (SSD-VGG16-300, 8732
   anchors) at batch 32 x 3 x 300 x 300 in fp32 through ``simple_bind``,
   Xavier (the conv4_3 scale at its own init, 20), SGD lr 1e-3 momentum
   0.9 wd 5e-4 through ``optimizer.get_updater``, over the example's 64
   synthetic images on the card: 20 timed steps after 3 (images/s, step
   ms, MFU, 0 host syncs a step, peak memory, a falling class loss) and
   a profile with device ms of convolutions, ``MultiBoxTarget``, the NMS
   loop of the ``det_out`` output and the rest, and launch calls a step
   (in the NMS loop among them);
32. SSD detection (``phase_ssd_detect``): the deploy graph (softmax +
   ``MultiBoxDetection``) with the trained weights through the
   ``Predictor`` at batch 32: images/s over 20 calls, the NMS loop's
   share of a forward, the first 4 images' detections against the port
   on the CPU, the op alone on the card against the CPU on the same
   inputs, VOC mAP (examples/ssd/eval_metric.py's metrics) over the 64
   images;
33. Faster R-CNN (``phase_rcnn``, examples/rcnn at its config's sizes,
   batch 8 x 3 x 64 x 64): the eval graph (RPN -> ``Proposal`` ->
   ``ROIPooling`` -> head) and a ``train_rois=True`` step with its
   backward through ``ROIPooling``, each against the CPU from the same
   weights, then ms per forward and per step and ``Proposal``'s NMS
   launch calls;
34. LSTM-OCR (``phase_ocr``, examples/warpctc/lstm_ocr.py at its
   defaults: batch 32 of 16 x 48 captchas, ``LSTMCell(48)`` over 48
   columns, ``WarpCTC``, Adam lr 4e-3): the first step's loss and
   gradients against the CPU, 200 steps (steps/s, the CTC loss first and
   last, the CTC backward's device ms and launch calls), the greedy
   decode's sequence accuracy on a held-out batch.  Phases 31-34 launch
   none of the six hand-written kernels (their counts are read around
   them: ``launches_detection``);
35. the autotuner (``phase_autotune``): serving ``MFU_HEADLINE_CONFIG``
   in bf16 (8 slots, 16-token pages, ``max_len`` 1024) under
   ``MXTPU_SCHEDULE_CACHE=search:<tmp>``: every paged candidate's µs per
   tick (all layers; the kernel's splits), the search's trials, its
   winner (a split of the kernel) and seconds, a second ``PagedSlots``
   hitting the cache
   with 0 trials, ``readonly:`` on a fresh path writing nothing and
   keeping the default, the 16 prompts served under the winner and under
   the default schedule (greedy tokens equal, or teacher-forced logits
   within ``phase_parity``'s tolerance; the kernel launched on every layer
   of every tick of both); then ``residual_epilogue.tune``
   on ResNet-50's four tails at batch 32 in fp32 and bf16 (every launch
   schedule's µs, each bit-equal to the default's output, the winner
   against the default and the bound), the tuned Predictor's fp32
   outputs bit-equal to the untuned one's, the program cache's
   fingerprint moving with the search (``launches_autotune``);
36. the health and perf planes (``phase_planes``): the LM step
   (``MFU_HEADLINE_CONFIG``, b8 x 1024, bf16 Adam) through
   ``FusedTrainer.fit`` with ``MXTPU_PERF_ATTR``, ``MXTPU_FLIGHT_RECORD``
   and ``MXTPU_SENTINEL=raise``: step ms with the planes on and off, host
   syncs a batch (0), the plane's MFU beside this script's own, the cost
   row's FLOPs beside the analytic count, the flight ring's length, the
   ``/profile`` top rows; then one parameter set to inf (a
   ``NumericsError`` naming it at the epoch boundary, and a flight dump),
   one oversized ``torch.empty`` (``DeviceOOMError`` with the ranked
   report) and 20 decode ticks with the perf plane on (the decode cost
   rows and step buckets; ``launches_planes``);
37. the predict ABI (``phase_c_predict``, run with phase 38 right after
   phase 2, while this process holds little of the card, since each
   starts a C program that needs its own memory): a C program
   (``mxnet_tpu_torch/csrc/clients/predict.c``) built with ``gcc``
   against the port's predict library runs ResNet-50 at batch 32 in fp32
   on the card (``dev_type`` 2) from the symbol's JSON and the bytes of
   an ``nd.save`` file: 20 timed calls of ``MXPredSetInput`` +
   ``MXPredForward`` + ``MXPredGetOutput`` (images/s) and two
   ``MXPredForwardAsync`` tickets; its probabilities against the Python
   ``Predictor`` in this process within ``MODULE_PREDICT_TOL`` (both
   with TF32 off: ``NVIDIA_TF32_OVERRIDE=0`` in the child); then the
   same library loaded here through ``ctypes``, 4 epilogue launches a
   forward, each held against the plain version
   (``launches_c_predict``);
38. the general C API (``phase_c_api``): a C++ client on
   ``bindings/cpp/mxtpu.hpp`` (``csrc/clients/train_step.cc``) binds
   ResNet-50 at batch 32 on the card through ``MXExecutorSimpleBind``
   and takes 3 steps of forward(is_train=1) + backward, every weight
   updated on the card by ``MXImperativeInvoke("sgd_update")``; its
   first gradients against the port's Python ``Executor`` in this
   process within ``MODULE_TOL["vs_trainer"]``, step ms beside the
   Python loop's; ``bindings/cpp/example_train.cc``, unchanged, built
   against the same library prints ``CPP TRAIN OK`` (``launches_c_api``);
39. the native runtime (``phase_native``): the core library and
   ``_mxtpu_ext`` built from ``src/`` into ``build/`` and used by the
   host engine; the engine's per-var order, parallel readers, a task's
   error at ``wait_for_var`` and tasks/s through both FFI backends; one
   arena pool shared by both backends behind ``resource``'s temp space;
   then phase 15's stacked route rerun with telemetry on:
   ``data_batches_total`` of the consuming stage equal to the batches
   consumed, the wait histogram counting as many, 0 host syncs a batch
   (``launches_native``);
40. MXNet's parameter-server training (``phase_dist_sync``, run right
   after phases 37-38 for the same reason): ``python -m
   mxnet_tpu_torch.launch -n 2 -s 2 --launcher local`` on a worker script
   this file writes (``DIST_WORKER``); each worker trains ResNet-50 at
   full width (3 x 224 x 224, 1000 classes, fp32, cuDNN deterministic,
   TF32 off) at batch 32 through ``Module.fit(kvstore="dist_sync")`` for
   12 steps over its own seeded shard on the card, with SGD (momentum)
   on the two CPU-only servers, and joins a coordinator this process
   runs (``MXTPU_COORD_ADDR``; its ``/cluster`` and ``/fleet``, with
   both workers' metric families merged, and the step-time skew are
   printed).  Checked: the two workers' weights bit-equal after every
   step (a 64-bit digest of their bits taken on the card each step, and
   the weights themselves after steps 1 and 12); after step 1 the pulled
   weights bit-equal to the servers' update applied here on the host
   (the port's updater, each server's share of each key) to the two
   workers' own saved step-1 gradients; after 12 steps the weights
   within ``DIST_TOL`` of a one-process run here that sums the two
   shards' gradients each step; the servers never initialised CUDA; the
   six kernels' counts in each worker 0 (``launches_dist_sync``).
   Printed: images/s across both workers and step ms, per step the
   push and pull waits on the loop's thread and the bytes moved, the
   servers' update ms, and bench.py's PS micro shape timed by the same
   workers (``dist_step_us_per_step_ps``);
41. ``dist_async`` (``phase_dist_async``): the same model with ``-n 2 -s
   1 --max-restarts 1`` for 6 steps a worker over 2 repeated batches;
   worker 1 dies at the coordinator poll of its 4th batch
   (``MXTPU_FAULT_PLAN=host_crash:crash_after:3``) and is restarted with
   ``MXTPU_KV_RECOVERY=1``: it pulls the servers' trained model (not its
   own initialisation), worker 0's ``get_num_dead_node`` sees it dead,
   worker 0's loss falls, and images/s and the restart's wall are
   printed (``launches_dist_async``).

Any failure raises and exits nonzero.  The second-to-last lines are the
``{"kernels": [...]}`` record and the ``nvidia-smi`` name/power line;
the last line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py                 # needs one card
"""
from __future__ import annotations

import ctypes
import gc
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and flop/s for
# the kernel's input type (fp32 outside the tensor cores; bf16 tensor)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

# the slice's shapes: MFU_HEADLINE_CONFIG served with max_len 1024
SLOTS, HEADS, DH, BLOCK, LAYERS, MAX_LEN = 8, 16, 128, 16, 8, 1024
PAGED_SRC = "mxnet_tpu_torch/ops/csrc/paged_attention.cu"
PAGED_REPLACES = "mxnet_tpu/ops/paged_attention.py:170"  # _pallas_attention
# the paged kernel's design and its entry functions in the build log
# (split, combine) by route
PAGED_DESIGN = ("split across the sequence: one CTA per (slot, head, "
                "chunk of whole pages), 16-byte loads, online softmax; "
                "then a combine kernel per (slot, head) in chunk order")
PAGED_ENTRIES = {
    "bf16": ("paged_split_kernelI13__nv_bfloat16Li1E",
             "paged_combine_kernelI13__nv_bfloat16E"),
    "fp32": ("paged_split_kernelIfLi1E", "paged_combine_kernelIfE"),
}

# the training slice: MFU_HEADLINE_CONFIG at batch 8; attention shape
# (B, H, T, D) = (8, 16, 1024, 128)
TRAIN_BATCH, TRAIN_STEPS = 8, 6
FLASH_SRC = "mxnet_tpu_torch/ops/csrc/flash_attention.cu"
FLASH_REPLACES = {  # the Pallas kernels in mxnet_tpu/ops/flash_attention.py
    "flash_fwd": "mxnet_tpu/ops/flash_attention.py:41",       # _fwd_kernel
    "flash_bwd_dq": "mxnet_tpu/ops/flash_attention.py:86",    # _bwd_dq_kernel
    "flash_bwd_dkv": "mxnet_tpu/ops/flash_attention.py:118",  # _bwd_dkv_kernel
}
# each flash kernel's build facts: its kernel argument of
# mxtt_flash_smem_bytes, how it runs, and its entry functions in the
# build log (bf16 route, fp32 route).  All three take the tensor-core
# kernels in bf16 and the CUDA-core kernels in fp32
FLASH_BUILD = {
    "flash_fwd": (0, "wgmma+tma (bf16); CUDA cores (fp32)",
                  "flash_fwd_bf16_sm90ILi128E", "flash_fwd_kernelIfE"),
    "flash_bwd_dq": (1, "wgmma+tma (bf16); CUDA cores (fp32)",
                     "flash_dq_bf16_sm90ILi128E", "flash_bwd_dq_kernelIfE"),
    "flash_bwd_dkv": (2, "wgmma+tma (bf16); CUDA cores (fp32)",
                      "flash_dkv_bf16_sm90ILi128E", "flash_bwd_dkv_kernelIfE"),
}
# the inference slice: ResNet-50, 1000 classes, batch 32 x 3 x 224 x 224;
# the four residual tails the passes fuse, as (node, H*W, C)
PREDICT_BATCH, PREDICT_CALLS = 32, 20
EPI_SRC = "mxnet_tpu_torch/ops/csrc/residual_epilogue.cu"
EPI_REPLACES = "mxnet_tpu/ops/residual_epilogue.py:113"    # _pallas_fwd
EPI_TAILS = (("stage2_unit1_relu1", 56 * 56, 256),
             ("stage3_unit1_relu1", 28 * 28, 512),
             ("stage4_unit1_relu1", 14 * 14, 1024),
             ("relu1", 7 * 7, 2048))
KERNEL_SOURCES = ("paged_attention", "flash_attention", "residual_epilogue")
# the training slice of bench.py:1985-2077: ResNet-50, 1000 classes, SGD
# lr 0.1 momentum 0.9 rescale_grad 1/32, bf16, batch 32 x 3 x 224 x 224;
# 8 warm-up steps, 60 timed steps through step(), step_multi at k 8 (7
# calls, as bench.py runs 60 // 8 of them), 8 batches through fit
RESNET_BATCH, RESNET_WARMUP, RESNET_STEPS, RESNET_K = 32, 8, 60, 8
RESNET_FIT_BATCHES = 8
RESNET_FLOPS_PER_IMG = 3 * 4.089e9          # bench.py:34
# device time by kind of kernel, the first matching pattern winning
RESNET_KINDS = (
    ("conv wgrad", ("wgrad",)),
    ("conv dgrad", ("dgrad",)),
    ("conv fprop", ("fprop", "implicit_convolve", "conv2d", "convolve",
                    "cudnn")),
    ("layout converters", ("nchwToNhwc", "nhwcToNchw", "transpose",
                           "permute")),
    ("cat copies (Concat)", ("CatArray", "cat_")),
    ("reductions (BN moments and their gradients)", ("reduce_kernel",)),
    ("pooling", ("pool",)),
    ("gemm (FC)", ("gemm", "nvjet", "cutlass", "xmma")),
    ("copies and casts", ("copy", "Memcpy", "Memset", "memcpy", "memset")),
    ("elementwise (BN, ReLU, adds, update)", ("elementwise",)),
)
# the Module path of bench.py:1692-1776 (_amp_micro's fp32 half):
# ResNet-50 at batch 256 fp32 (TF32 off), Xavier, SGD lr 0.05 momentum
# 0.9, kvstore "local"; 2 warm-up and 12 timed steps through the eager
# Updater and through the bucketed update; parity at batch 32
MODULE_BATCH, MODULE_WARMUP, MODULE_STEPS = 256, 2, 12
MODULE_PARITY_BATCH = RESNET_BATCH
MODULE_OPT = {"learning_rate": 0.05, "momentum": 0.9}
MODULE_SCORE_BATCHES = 2
# (max, median) relative error over the parameters, and the max over the
# softmax, momentum and moving stats.  The Module against FusedTrainer:
# the same arithmetic on the same kernels (cuDNN deterministic) but for
# the order of independent launches, held as the captured-vs-eager step
# of phase 5b is.  Bucketed against eager: the same elementwise
# arithmetic, op for op, through foreach kernels: 1e-6
MODULE_TOL = {"vs_trainer": (1e-3, 1e-5), "bucket_vs_eager": (1e-6, 1e-6)}
# the AMP half of _amp_micro: the same Module cell under these knobs; MFU
# against the bf16 tensor-core peak, as bench.py states it
MODULE_AMP_ENV = {"MXTPU_AMP": "bf16", "MXTPU_LOSS_SCALE": "dynamic"}
# Module.predict against a Predictor running the same graph and kernels;
# a reloaded checkpoint's step against the writer's (the same state)
MODULE_PREDICT_TOL, MODULE_RELOAD_TOL = 1e-6, 1e-6
# channels-last vs NCHW, fp32, one step (see _resnet_parity_runs):
# (softmax and BN moving variances, parameters' median, their max)
NCHW_TOL = (1e-5, 1e-2, 1e-1)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cudaGraphLaunch")
SYNC_METHODS = ("item", "cpu", "tolist", "numpy", "__bool__", "__float__",
                "__int__")
# what torch.cuda.set_sync_debug_mode("warn") says at each sync
SYNC_WARNING = "called a synchronizing CUDA operation"
# the zoo slice.  Inception-v3 training as tools/bench_models.py:46-67
# runs it: batch 32 x 3 x 299 x 299, SGD lr 0.1 momentum 0.9, bf16;
# step_multi at k 8 against 8 step() calls, 24 timed steps a route
INCEPTION_BATCH, INCEPTION_K, INCEPTION_WARMUP = 32, 8, 3
INCEPTION_STEPS = 24
# AlexNet through Module (BASELINE.md:44-55): batch 256, fp32, 10 timed
# steps a route over one repeated batch
ALEXNET_BATCH, ALEXNET_WARMUP, ALEXNET_STEPS = 256, 2, 10
# the inference sweep of tools/benchmark_score.py:23-56, models at
# :62-63 (native image side each), batch 32, 20 timed calls
ZOO_MODELS = (("alexnet", 224), ("vgg", 224), ("googlenet", 224),
              ("inception-bn", 224), ("inception-v3", 299),
              ("inception-resnet-v2", 299), ("resnext-50", 224),
              ("resnet-50", 224), ("resnet-152", 224))
ZOO_BATCH, ZOO_CALLS = 32, 20
# card fp32 (TF32 off) logits against torch's CPU kernels, batch 2: the
# same fp32 arithmetic in other algorithms (cuDNN's implicit GEMMs and
# FFTs against the CPU's), a few fp32 ulps a layer over up to ~250
# layers (measured 3.4e-7 to 3.5e-6 relative on an H100)
ZOO_TOL = 1e-4
# the LSTM language model.  (a) lstm.get_symbol through FusedTrainer as
# tools/bench_models.py:70-102 runs it: batch 32 x 35 tokens, 2 x 200,
# vocab 10000, dropout 0.2, SGD lr 1.0 rescale_grad 1/32, bf16 with fp32
# masters, the l{i}_init_{c,h} states fed as zeros; step_multi at k 8
LSTM_BATCH, LSTM_SEQ, LSTM_HIDDEN, LSTM_LAYERS = 32, 35, 200, 2
LSTM_VOCAB, LSTM_DROPOUT, LSTM_K = 10000, 0.2, 8
LSTM_WARMUP, LSTM_STEPS = 3, 24
# FLOPs a step: 3 x (the 2 layers' i2h and h2h products, 2 x 4H x (E+H)
# a token each, and the 4.0 M multiply-adds of the logits) x 2 a token
LSTM_FLOPS_PER_TOKEN = 3 * 2 * (LSTM_LAYERS * 4 * LSTM_HIDDEN
                                * (2 * LSTM_HIDDEN) + LSTM_HIDDEN
                                * LSTM_VOCAB)
# step_multi(8) against 8 step() calls from the same state and generator
# state: (max, median) of the parameters' errors relative to their
# norms, and the max over the softmax.  The graph replays the eager
# step's kernels, and the card's Embedding backward sorts the ids and
# sums each id's rows in a fixed order (no atomics), so the two came out
# bit-equal on an H100 (the record says whether they were); the bounds
# hold what a kernel with an unfixed order would leave: fp32 (TF32 off)
# 1e-4 / 1e-6, bf16 1e-2 / 1e-3
LSTM_TOL = {"fp32": (1e-4, 1e-6), "bf16": (1e-2, 1e-3)}
# the dropout graph's keep rate over 8 captured steps: within 4 sigma of
# 0.8 (sigma = sqrt(0.16 / elements))
LSTM_KEEP_SIGMAS = 4.0
# device time by kind of kernel for the LSTM steps, the first match
# winning (the embedding's backward sorts the ids and reduces segments)
LSTM_KINDS = (
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "splitK", "sm90_")),
    ("embedding", ("indexSelect", "index_select", "embedding",
                   "indexing_backward", "RadixSort", "radix", "segment",
                   "compute_grad_weight", "krn_partial", "sum_and_scatter",
                   "index_put", "indexFunc")),
    ("softmax / logits", ("softmax", "SoftMax")),
    ("cat copies (Concat)", ("CatArray", "cat_")),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy", "Memcpy", "Memset", "memcpy", "memset")),
    ("elementwise (cells, dropout, update)", ("elementwise",)),
)
# FusedRNNCell (the RNN op) against the unrolled LSTMCell stack it
# unpacks into, 2 x 200 at T 35 and batch 32, fp32 (TF32 off): the same
# products in another grouping
LSTM_CELL_TOL = 1e-5
# (b) examples/rnn/lstm_bucketing.py through BucketingModule.fit: the
# example's Zipf corpus (synthetic_corpus, seed 3) at vocab 10000,
# buckets 8/16/24/32, batch 32, 2 x 200, dropout 0.2, ignore_label 0,
# SGD lr 0.1 momentum 0.9 wd 1e-5, Xavier(in, 2.34), fp32 (TF32 off)
BUCKET_SENTENCES, BUCKETS = 2000, (8, 16, 24, 32)
BUCKET_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-5}
# the runtime-compiled kernels: rtc.Rtc replaces the JAX Rtc._compiled
RTC_SRC = "mxnet_tpu_torch/rtc.py"
RTC_REPLACES = "mxnet_tpu/rtc.py:62"                     # Rtc._compiled


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- phase 1
def phase_device():
    from mxnet_tpu_torch.ops import _build

    smi = nvidia_smi_line()
    log(f"[device] {smi} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build(KERNEL_SOURCES)
    log(f"[device] built or loaded {', '.join(KERNEL_SOURCES)} in "
        f"{time.perf_counter() - t0:.2f} s (one nvcc per source, in "
        f"parallel)")
    ptxas = {name: ptxas_report(_build.build_logs.get(name, ""))
             for name in KERNEL_SOURCES}
    for name, entries in ptxas.items():
        for entry, r in entries.items():
            log(f"[ptxas] {name}: {entry}: {r.get('registers')} registers, "
                f"{r.get('spills')} bytes spilled")
    return smi, ptxas


def ptxas_report(log):
    """``{entry function: {"registers": r, "spills": bytes}}`` from the
    ``-Xptxas -v`` lines of an nvcc log (spills = spill stores + loads)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spills"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def paged_build_record(report):
    """Registers and spills of the paged kernel's split and combine entry
    functions (bf16 at dh 128, and the fp32 twins), from ``report``."""
    def entry(fragment):
        return next((v for k, v in report.items() if fragment in k), {})

    rec = {"design": PAGED_DESIGN}
    for route, prefix in (("bf16", ""), ("fp32", "fp32_")):
        split, combine = (entry(f) for f in PAGED_ENTRIES[route])
        rec[prefix + "registers"] = [split.get("registers"),
                                     combine.get("registers")]
        rec[prefix + "spills"] = [split.get("spills"), combine.get("spills")]
    return rec


def flash_build_record(report, name):
    """Registers and spills of a flash kernel's bf16 and fp32 entry
    functions, from ``report`` (``ptxas_report`` of the library's build),
    and the dynamic shared memory its launches ask for at D 128, as the
    library reports it."""
    from mxnet_tpu_torch.ops import _build

    fn = _build.load("flash_attention").mxtt_flash_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int

    def entry(fragment):
        return next((v for k, v in report.items() if fragment in k), {})

    index, design, bf16_entry, fp32_entry = FLASH_BUILD[name]
    bf16, fp32 = entry(bf16_entry), entry(fp32_entry)
    return {"design": design,
            "registers": bf16.get("registers"), "spills": bf16.get("spills"),
            "smem_bytes": fn(index, 1, DH),
            "fp32_registers": fp32.get("registers"),
            "fp32_spills": fp32.get("spills"),
            "fp32_smem_bytes": fn(index, 0, DH)}


# ----------------------------------------------------------------- phase 2
def _time_ms(fn, n, warmup=5):
    """Mean ms of ``fn(i)`` over ``n`` calls, CUDA events around all."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(n):
        fn(i)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


def _bound_ms(cursor, B, H, M, block, dh, dtype):
    """The least time for one call: the K/V rows the function needs (the
    ``cursor_b + 1`` live positions of each slot, not the rest of its last
    page) + q + out + the live block-table entries and cursors over the
    memory rate, or the flops over the peak for the input type —
    whichever is larger."""
    item = torch.tensor([], dtype=dtype).element_size()
    rows = sum(min(c + 1, M * block) for c in cursor)
    pages = sum(min(math.ceil((c + 1) / block), M) for c in cursor)
    nbytes = (rows * H * dh * 2 * item + 2 * B * H * dh * item
              + pages * 4 + B * 4)
    flops = rows * H * 4 * dh
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _device_call_ms(fn, n, pattern=""):
    """Device ms per call of ``fn(i)`` over ``n`` calls: the kernels whose
    names contain ``pattern`` (every kernel for ""), summed, from
    torch.profiler.  Unlike ``_time_ms`` it does not count the host's
    time per call where that is longer than the kernels'."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    return sum(t for t, name in _device_ms(prof, n) if pattern in name)


def kernel_check(name, dtype, tol, B, H, M, block, dh, L, cursor, seed):
    """Kernel vs plain on every layer, twice (the same bits both times);
    times of kernel / plain / SDPA rotate over the layers so each call
    finds its pages cold in L2, as a decode tick does (all L layers of
    live pages exceed the 50 MB L2).  CUDA events time the calls back to
    back, which counts the wrapper's host time once the kernels are
    shorter; torch.profiler gives the kernels' device time per call (the
    split and the combine kernel), which the roofline share uses."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    P = B * M + 1
    pk = torch.randn((P, L, H, block, dh), generator=g, device=dev).to(dtype)
    pv = torch.randn((P, L, H, block, dh), generator=g, device=dev).to(dtype)
    q = torch.randn((B, H, 1, dh), generator=g, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=g, device=dev)[:B * M] + 1
    bt = perm.reshape(B, M).to(torch.int32).contiguous()
    cur = torch.tensor(cursor, dtype=torch.int32, device=dev)
    err = 0.0
    for layer in range(L):
        got = pa.paged_attention(q, pk, pv, bt, cur, layer, block=block)
        again = pa.paged_attention(q, pk, pv, bt, cur, layer, block=block)
        ref = pa._gather_attention(q, pk, pv, bt, cur, layer, block)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"kernel check {name} layer {layer}: two "
                                 "calls on the same inputs differ")
        diff = (got.float() - ref.float()).abs()
        err = max(err, float(diff.max()))
        bad = diff > tol + tol * ref.float().abs()
        if bool(bad.any()):
            raise AssertionError(
                f"kernel check {name} layer {layer}: {int(bad.sum())} values "
                f"outside atol=rtol={tol}; max abs err {float(diff.max())}")
    kc = [pa.gather_tables(pk, bt, block, i) for i in range(L)]
    vc = [pa.gather_tables(pv, bt, block, i) for i in range(L)]
    S = M * block
    mask = (torch.arange(S, device=dev)[None, :] <= cur[:, None].long())
    mask = mask[:, None, None, :]
    scale = 1.0 / pa._scale(dh, dtype)
    sdpa = F.scaled_dot_product_attention(q, kc[0], vc[0], attn_mask=mask,
                                          scale=scale)
    lib_err = float((sdpa.float() - pa._gather_attention(
        q, pk, pv, bt, cur, 0, block).float()).abs().max())
    n = 200
    t_k = _time_ms(lambda i: pa.paged_attention(
        q, pk, pv, bt, cur, i % L, block=block), n)
    t_p = _time_ms(lambda i: pa._gather_attention(
        q, pk, pv, bt, cur, i % L, block), n // 4)
    t_l = _time_ms(lambda i: F.scaled_dot_product_attention(
        q, kc[i % L], vc[i % L], attn_mask=mask, scale=scale), n)
    d_k = _device_call_ms(lambda i: pa.paged_attention(
        q, pk, pv, bt, cur, i % L, block=block), n, "paged_")
    d_l = _device_call_ms(lambda i: F.scaled_dot_product_attention(
        q, kc[i % L], vc[i % L], attn_mask=mask, scale=scale), n)
    bound, bound_by = _bound_ms(cursor, B, H, M, block, dh, dtype)
    chunk_pages, n_split = pa.split_of(M, block)
    log(f"[kernel] {name}: max_abs_err={err:.3g} (atol=rtol={tol}), same "
        f"bits twice; device_us={d_k * 1e3:.2f} (split + combine, "
        f"profiler) events_us={t_k * 1e3:.2f} plain_us={t_p * 1e3:.2f} "
        f"library_us={t_l * 1e3:.2f} library_device_us={d_l * 1e3:.2f} "
        f"(sdpa err {lib_err:.3g}) bound_us={bound * 1e3:.2f} ({bound_by}); "
        f"roofline share {bound / d_k:.4f}; n_split {n_split} of "
        f"{chunk_pages} pages")
    return {"max_abs_err": err, "ms": t_k, "device_ms": d_k,
            "plain_ms": t_p, "library_ms": t_l, "library_device_ms": d_l,
            "bound_ms": bound, "bound_by": bound_by,
            "roofline_share": bound / d_k, "n_split": n_split,
            "chunk_pages": chunk_pages}


def phase_kernels():
    M = MAX_LEN // BLOCK
    ragged = [0, BLOCK - 1, BLOCK, BLOCK + 1, 255, 511, 700, MAX_LEN - 1]
    # tolerances: fp32 — the kernel sums in another order than cuBLAS's
    # einsums, a few fp32 ulps on outputs of order 1.  bf16 — both read
    # the same bf16 inputs, accumulate in fp32 and round once, so they
    # part only where a sum lands next to a rounding boundary: one bf16
    # ulp, 2^-8 to 2^-7 of the value.  These outputs are softmax averages
    # of unit-normal V rows, mostly below 0.5 (ulp <= 0.002); 4e-3 + 4e-3
    # relative holds one ulp up to magnitude 2 and is well under what a
    # dropped live position (~1/cursor of the output) or a bf16 rounding
    # of scores or weights (~0.016 measured) would move
    out = {}
    out["fp32"] = kernel_check("fp32 B8 H16 dh128 block16 M64",
                               torch.float32, 1e-5, SLOTS, HEADS, M, BLOCK,
                               DH, LAYERS, ragged, 1)
    out["bf16"] = kernel_check("bf16 B8 H16 dh128 block16 M64",
                               torch.bfloat16, 4e-3, SLOTS, HEADS, M, BLOCK,
                               DH, LAYERS, ragged, 2)
    ragged8 = [0, 7, 8, 9, 255, 511, 700, MAX_LEN - 1]
    for tag, dt, tol in (("fp32", torch.float32, 1e-5),
                         ("bf16", torch.bfloat16, 4e-3)):
        kernel_check(f"{tag} B8 H16 dh64 block8 M128", dt, tol, SLOTS,
                     HEADS, MAX_LEN // 8, 8, 64, LAYERS, ragged8, 3)
    return out


def _flash_bound_ms(kind, B, H, T, D, dtype, causal):
    """The least time for one call: each input read once and each output
    written once over the memory rate, or the products' flops over the
    peak for the input type, whichever is larger.  Causal attention
    needs the T(T+1)/2 (query, key) pairs on or below the diagonal;
    every pair costs 2*D flops in each product: 2 products in the
    forward (QK^T, PV), 3 in dQ (QK^T, dO V^T, dS K), 4 in dK/dV (QK^T,
    dO V^T, P^T dO, dS^T Q)."""
    item = torch.tensor([], dtype=dtype).element_size()
    pairs = T * (T + 1) // 2 if causal else T * T
    n, rows = B * H * T * D, B * H * T
    products, nbytes = {
        "fwd": (2, 4 * n * item + rows * 4),              # q k v -> o, lse
        "dq": (3, 5 * n * item + 2 * rows * 4),           # q k v do lse d -> dq
        "dkv": (4, 6 * n * item + 2 * rows * 4),          # ... -> dk dv
    }[kind]
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = 2 * products * B * H * pairs * D / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the per-tile check of the flash outputs: the checks' labels by kernel,
# and its limit by dtype (see flash_check)
TILES_OF = {"flash_fwd": ("fwd O",), "flash_bwd_dq": ("dQ",),
            "flash_bwd_dkv": ("dK", "dV")}
FLASH_TILE_TOL = {torch.bfloat16: 1e-2}


def tile_rel_err(got, ref, rows=64):
    """The largest ``||got - ref|| / ||ref||`` over the tiles of ``rows``
    consecutive rows (all D columns; the last tile may be short) of two
    ``(..., T, D)`` tensors."""
    import torch.nn.functional as F

    ref = ref.float()
    pad = -ref.shape[-2] % rows

    def norms(x):
        x = F.pad(x, (0, 0, 0, pad))
        return x.reshape(*x.shape[:-2], -1, rows * x.shape[-1]).norm(dim=-1)

    return float((norms(got.float() - ref)
                  / norms(ref).clamp_min(1e-30)).max())


def flash_check(dtype, causal, seed, B=TRAIN_BATCH, H=HEADS, T=MAX_LEN,
                D=DH):
    """Forward, dQ and dK/dV kernels against their plain versions on the
    same inputs, with kernel / plain / library times and bounds.
    Tolerances: fp32 — the kernels sum in another order than the plain
    version's cuBLAS products (TF32 off): 1e-5 on the forward (weighted
    means of unit-normal rows, order 1) and 1e-4 on the backward (sums
    of up to T products that may cancel).  bf16 — both sides widen the
    same bf16 inputs and accumulate in fp32; the tensor-core forward and
    dK/dV also round P (and dS) to bf16 as the A operand of their
    products, 2^-9 relative per term.  Each element within 1e-2
    absolute and relative (one output ulp is 2^-8 to 2^-7 of the value)
    is loose where O, dK and dV are ~0.02-0.05, so each tile of 64 rows
    (64 queries' O or dQ, 64 keys' dK or dV) is also held to
    ``FLASH_TILE_TOL`` of its norm (``tile_rel_err``; a single row of D
    8 is too few values for a norm to average the roundings); a dK/dV
    that leaves out one query tile, and a dQ that leaves out one key
    tile, must fail that check, and both are tried on every bf16
    call."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((B, H, T, D), generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    scale = D ** -0.5
    fwd_tol, bwd_tol = ((1e-5, 1e-4) if dtype == torch.float32
                        else (1e-2, 1e-2))
    tag = (f"{str(dtype).replace('torch.', '')} "
           f"{'causal' if causal else 'full'} B{B} H{H} T{T} D{D}")

    tile_tol = FLASH_TILE_TOL.get(dtype)
    tiles = {}

    def check(name, got, ref, tol, by_tile=True):
        diff = (got.float() - ref.float()).abs()
        bad = diff > tol + tol * ref.float().abs()
        if bool(bad.any()):
            raise AssertionError(
                f"flash kernel check {name} {tag}: {int(bad.sum())} values "
                f"outside atol=rtol={tol}; max abs err {float(diff.max())}")
        if by_tile:
            tiles[name] = tile_rel_err(got, ref)
            if tile_tol is not None and tiles[name] > tile_tol:
                raise AssertionError(
                    f"flash kernel check {name} {tag}: a 64-row tile is "
                    f"{tiles[name]:.3g} of its norm off (limit {tile_tol})")
        return float(diff.max())

    o, lse = fa._cuda_fwd(q, k, v, scale, causal)
    po, plse = fa.fwd_plain(q, k, v, scale, causal)
    torch.cuda.synchronize()
    errs = {"flash_fwd": max(check("fwd O", o, po, fwd_tol),
                             check("fwd LSE", lse, plse, 1e-5,
                                   by_tile=False))}
    delta = (po.float() * do.float()).sum(-1)
    args = (q, k, v, do, plse, delta, scale, causal)
    pdq = fa.dq_plain(*args)
    errs["flash_bwd_dq"] = check("dQ", fa._cuda_dq(*args), pdq, bwd_tol)
    dk, dv = fa._cuda_dkv(*args)
    pdk, pdv = fa.dkv_plain(*args)
    errs["flash_bwd_dkv"] = max(check("dK", dk, pdk, bwd_tol),
                                check("dV", dv, pdv, bwd_tol))
    log(f"[kernel] flash tiles {tag}: largest |got - plain| / |plain| of "
        f"a 64-row tile: "
        + ", ".join(f"{n} {e:.3g}" for n, e in tiles.items())
        + (f" (limit {tile_tol})" if tile_tol else ""))
    if tile_tol is not None:
        # a wrong kernel: dK/dV with the query tile [T/2, T/2 + 64) left
        # out of every sum (its dO rows, and so its dS rows, set to 0)
        cut = do.clone()
        cut[:, :, T // 2:T // 2 + 64] = 0
        wdk, wdv = fa.dkv_plain(q, k, v, cut, plse,
                                (po.float() * cut.float()).sum(-1), scale,
                                causal)
        wrong = {"dK": tile_rel_err(wdk, pdk), "dV": tile_rel_err(wdv, pdv)}
        outside = sum(int(((w.float() - r.float()).abs() > bwd_tol + bwd_tol
                           * r.float().abs()).sum())
                      for w, r in ((wdk, pdk), (wdv, pdv)))
        log(f"[kernel] flash tiles {tag}: dK/dV without one query tile "
            f"reads dK {wrong['dK']:.3g}, dV {wrong['dV']:.3g} (limit "
            f"{tile_tol}); {outside} values outside the elementwise "
            f"atol=rtol={bwd_tol}")
        if min(wrong.values()) <= tile_tol:
            raise AssertionError(
                f"flash kernel check {tag}: the tile check passes a dK/dV "
                f"that leaves out a query tile: {wrong}")
        # a wrong dQ: the key tile [T/2, T/2 + 64) left out of every sum
        # (its K rows set to 0: dS.K loses exactly those terms, and no
        # other term changes)
        cut_k = k.clone()
        cut_k[:, :, T // 2:T // 2 + 64] = 0
        wdq = fa.dq_plain(q, cut_k, v, do, plse, delta, scale, causal)
        wrong_dq = tile_rel_err(wdq, pdq)
        log(f"[kernel] flash tiles {tag}: dQ without one key tile reads "
            f"{wrong_dq:.3g} (limit {tile_tol})")
        if wrong_dq <= tile_tol:
            raise AssertionError(
                f"flash kernel check {tag}: the tile check passes a dQ "
                f"that leaves out a key tile: {wrong_dq}")
        del cut, wdk, wdv, cut_k, wdq
    del o, lse, dk, dv, pdk, pdv, pdq

    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    lib_err = float((lib_out.detach().float() - po.float()).abs().max())
    n, n_plain = 10, 3
    t_lib_fwd = _time_ms(lambda i: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal), n, 2)
    t_lib_bwd = _time_ms(lambda i: torch.autograd.grad(
        lib_out, (qg, kg, vg), do, retain_graph=True), n, 2)
    timed = {
        "flash_fwd": ("fwd", lambda i: fa._cuda_fwd(q, k, v, scale, causal),
                      lambda i: fa.fwd_plain(q, k, v, scale, causal),
                      t_lib_fwd),
        "flash_bwd_dq": ("dq", lambda i: fa._cuda_dq(*args),
                         lambda i: fa.dq_plain(*args), t_lib_bwd),
        "flash_bwd_dkv": ("dkv", lambda i: fa._cuda_dkv(*args),
                          lambda i: fa.dkv_plain(*args), t_lib_bwd),
    }
    out = {}
    for name, (kind, kern, plain, t_lib) in timed.items():
        t_k = _time_ms(kern, n, 2)
        t_p = _time_ms(plain, n_plain, 1)
        bound, bound_by = _flash_bound_ms(kind, B, H, T, D, dtype, causal)
        out[name] = {"max_abs_err": errs[name],
                     "max_tile_rel_err": max(tiles[c]
                                             for c in TILES_OF[name]),
                     "ms": t_k, "plain_ms": t_p,
                     "library_ms": t_lib, "bound_ms": bound,
                     "bound_by": bound_by}
        log(f"[kernel] {name} {tag}: max_abs_err={errs[name]:.3g} "
            f"kernel_us={t_k * 1e3:.2f} plain_us={t_p * 1e3:.2f} "
            f"library_us={t_lib * 1e3:.2f} bound_us={bound * 1e3:.2f} "
            f"({bound_by}); roofline share {bound / t_k:.4f}")
    log(f"[kernel] library = scaled_dot_product_attention {tag}: forward "
        f"(flash_fwd) and its whole backward through autograd, dQ dK dV "
        f"in one call (flash_bwd_dq, flash_bwd_dkv); its forward differs "
        f"from the plain version by {lib_err:.3g}")
    del qg, kg, vg, lib_out
    torch.cuda.empty_cache()
    return out


def phase_flash_kernels(ptxas):
    """The flash kernels' checks in bf16 and fp32, causal and full, and
    their build records."""
    builds = {}
    for name in FLASH_BUILD:
        builds[name] = flash_build_record(ptxas["flash_attention"], name)
        log(f"[build] {name}: {json.dumps(builds[name])}")
    out = {}
    for i, (dtype, causal) in enumerate(
            ((torch.bfloat16, True), (torch.float32, True),
             (torch.bfloat16, False), (torch.float32, False))):
        out[(dtype, causal)] = flash_check(dtype, causal, 10 + i)
    return out, builds


# ----------------------------------------------------------------- phase 3
def _params(seed=0):
    from mxnet_tpu_torch.models import transformer as tr

    cfg = tr.MFU_HEADLINE_CONFIG
    shapes = tr.lm_param_shapes(cfg["num_layers"], cfg["num_heads"],
                                cfg["d_model"], cfg["d_ff"],
                                cfg["vocab_size"], MAX_LEN)
    return cfg, tr.lm_random_params(shapes, seed=seed, std=0.02)


def _post(port, body, timeout=600):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps(body).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}")


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def phase_serve(cfg, params):
    from mxnet_tpu_torch import telemetry as tm
    from mxnet_tpu_torch.models.decode import KVDecoder
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.serving import serve_decoder

    V = cfg["vocab_size"]
    tm.enable()
    t0 = time.perf_counter()
    dec = KVDecoder(params, num_layers=cfg["num_layers"],
                    num_heads=cfg["num_heads"], max_len=MAX_LEN,
                    dtype=torch.bfloat16)
    log(f"[serve] decoder bf16 on {dec.device}: "
        f"{sum(p.numel() for p in dec.p.values()) / 1e9:.3f} B params, "
        f"loaded in {time.perf_counter() - t0:.1f} s")
    server, sched = serve_decoder(dec, num_slots=SLOTS, paged=True,
                                  kv_block=BLOCK, queue_size=32)
    try:
        port = server.server_address[1]
        if sched.backend.kernel != "cuda":
            raise AssertionError(f"paged backend picked "
                                 f"{sched.backend.kernel!r}, not the kernel")
        # warm-up request (cuBLAS handles, allocator), outside the counts
        st, body = _post(port, {"prompt": [1, 2, 3], "max_tokens": 2})
        if st != 200 or body.get("outcome") != "ok":
            raise AssertionError(f"warm-up request failed: {st} {body}")
        rng = np.random.default_rng(1)
        prefix = rng.integers(0, V, 256).tolist()
        prompts = [prefix + rng.integers(0, V, int(n)).tolist()
                   for n in rng.integers(16, 201, 8)]
        prompts += [rng.integers(0, V, int(n)).tolist()
                    for n in rng.integers(16, 701, 8)]
        hits0 = tm.get_registry().get("serve_prefix_hits_total").total()
        tick0 = sched.stats["ticks"]
        tick_hist = tm.get_registry().get("serve_tick_seconds")
        tsum0, tcnt0 = tick_hist.sum(), tick_hist.count()
        # the main path's run: every kernel count starts at 0 here
        pa.reset_launch_count()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(prompts)) as ex:
            replies = list(ex.map(lambda p: _post(port, {
                "prompt": p, "max_tokens": 32, "temperature": 0,
                "deadline_ms": 600000}), prompts))
        wall = time.perf_counter() - t0
        launches = pa.launch_count()
        ticks = sched.stats["ticks"] - tick0
        # SlotScheduler._run turns any engine exception into outcome
        # "error" and keeps serving, so a kernel fault would still answer:
        # every reply's status, outcome and token count is checked
        for i, (st, body) in enumerate(replies):
            if st != 200 or body.get("outcome") != "ok" \
                    or body.get("n_tokens") != 32:
                raise AssertionError(f"request {i} (prompt "
                                     f"{len(prompts[i])}): HTTP {st} {body}")
            if not all(0 <= t < V for t in body["tokens"]):
                raise AssertionError(f"request {i}: token out of vocab")
        health = _get(port, "/healthz")
        if health.get("paged", {}).get("kernel") != "cuda":
            raise AssertionError(f"/healthz paged.kernel: {health}")
        snap = _get(port, "/metrics.json")["metrics"]
        hits = sum(s["value"] for s in
                   snap["serve_prefix_hits_total"]["samples"]) - hits0
        if hits <= 0:
            raise AssertionError("no prefix-cache hit for the 8 requests "
                                 "sharing a 256-token prefix")
        if ticks < 1 or launches < ticks * cfg["num_layers"]:
            raise AssertionError(f"kernel launched {launches} times in "
                                 f"{ticks} ticks x {cfg['num_layers']} "
                                 "layers")
        ttft = sorted(r[1]["ttft_ms"] for r in replies)
        tick_ms = (tick_hist.sum() - tsum0) / max(
            tick_hist.count() - tcnt0, 1) * 1e3
        n_tok = sum(r[1]["n_tokens"] for r in replies)
        log(f"[serve] 16/16 ok, {n_tok} tokens in {wall:.3f} s = "
            f"{n_tok / wall:.1f} tok/s; TTFT p50 "
            f"{float(np.percentile(ttft, 50)):.1f} ms p99 "
            f"{float(np.percentile(ttft, 99)):.1f} ms; {ticks} ticks, mean "
            f"tick {tick_ms:.2f} ms; kernel launches {launches} "
            f"(= {launches / max(ticks, 1):.1f}/tick); prefix hits "
            f"{int(hits)} blocks; pages {health['paged']}")
        tick = tick_profile(dec)
        return launches, tick
    finally:
        server.shutdown()
        server.server_close()
        sched.close()


def _device_ms(prof, steps):
    """``[(device ms per step, kernel name)]`` from a torch.profiler run
    over ``steps`` steps, largest first."""
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t:
            rows.append((t / steps / 1e3, ev.key))
    return sorted(rows, reverse=True)


def tick_profile(dec, steps=10, tag="tick"):
    """Where a decode tick's time goes: 8 slots at ~500 cached tokens
    step the paged backend directly (the scheduler's tick minus its
    sampling).  Wall per tick from the host clock without the profiler;
    device time per kernel name from torch.profiler over the same
    number of ticks.  Idle share = 1 - device busy / wall."""
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.serving.paged_kv import PagedSlots

    pg = PagedSlots(dec, SLOTS, block=BLOCK, prefill_buckets=(512,),
                    kernel="auto")
    rng = np.random.default_rng(7)
    tok = np.zeros(SLOTS, np.int64)
    for b in range(SLOTS):
        tok[b] = int(pg.admit(b, rng.integers(0, dec.vocab, 500))
                     .float().argmax())
    occ = np.ones(SLOTS, bool)

    def tick():
        lg, _ = pg.step(tok, occ)
        tok[:] = lg.float().cpu().numpy().argmax(-1)

    for _ in range(3):
        tick()
    t0 = time.perf_counter()
    for _ in range(steps):
        tick()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            tick()
    rows = _device_ms(prof, steps)
    busy = sum(t for t, _ in rows)
    # the paged-attention kernels (paged_split_kernel and
    # paged_combine_kernel, one launch of each per layer; "paged_" also
    # matches the earlier one-kernel design, for tools/torch_ab.py)
    paged = {k: sum(t for t, name in rows if k in name)
             for k in ("paged_", "paged_split", "paged_combine")}
    log(f"[{tag}] 8 slots at ~500 tokens: {wall_ms:.3f} ms/tick wall, "
        f"device busy {busy:.3f} ms, idle share "
        f"{1 - busy / wall_ms:.3f}; paged attention {paged['paged_']:.3f} "
        f"ms (split {paged['paged_split']:.3f}, combine "
        f"{paged['paged_combine']:.3f}); top device time per tick: "
        + "; ".join(f"{name[:48]} {t:.3f} ms" for t, name in rows[:6]))
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": 1 - busy / wall_ms, "paged_ms": paged["paged_"]}


# ----------------------------------------------------------------- phase 4
def _drive(pg, V, forced=None):
    """The life cycle of tests/test_autotune.py:_drive at full width:
    admit slot 0 behind a 256-token prefix, 4 steps, fork slot 1 behind
    the same prefix blocks, 4 steps on both.  Greedy tokens
    are taken from this run's logits unless ``forced`` supplies them.
    Returns (logits of the live rows at every emission, tokens fed)."""
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, V, 256)
    fa = np.concatenate([prefix, rng.integers(0, V, 100)])
    fb = np.concatenate([prefix, rng.integers(0, V, 37)])
    outs, fed = [], []
    feed = iter(forced or ())

    def pick(row):
        return next(feed) if forced else int(row.argmax())

    def host(x):
        return x.float().cpu().numpy()

    outs.append(host(pg.admit(0, fa)))
    tok = np.zeros(pg.num_slots, np.int64)
    tok[0] = pick(outs[-1])
    fed.append(int(tok[0]))
    occ = np.zeros(pg.num_slots, bool)
    occ[0] = True
    for _ in range(4):
        lg, _ = pg.step(tok, occ)
        outs.append(host(lg)[:1])
        tok[0] = pick(outs[-1][0])
        fed.append(int(tok[0]))
    outs.append(host(pg.admit(1, fb)))
    tok[1] = pick(outs[-1])
    fed.append(int(tok[1]))
    occ[1] = True
    for _ in range(4):
        lg, _ = pg.step(tok, occ)
        outs.append(host(lg)[:2])
        for r in range(2):
            tok[r] = pick(outs[-1][r])
            fed.append(int(tok[r]))
    return outs, fed


def phase_parity(cfg, params):
    from mxnet_tpu_torch.models.decode import KVDecoder
    from mxnet_tpu_torch.serving.paged_kv import PagedSlots

    V = cfg["vocab_size"]
    buckets = tuple(2 ** i for i in range(3, 11))
    # fp32 — the kernel and the gather path differ only in the order of
    # fp32 sums inside attention (~1e-7 relative); 8 layers carry that to
    # about 2e-6 on logits up to ~4 (fp32 ulp 4.8e-7): 1e-5 is ~20 ulps.
    # bf16 — emission 1 is the kernel's first step, on pools both runs
    # prefilled identically: its logits must agree to under one bf16 ulp
    # of any logit of magnitude 2 or more (first_atol 1e-2; they agreed
    # exactly on the H100 so far).  After it, a one-ulp change in
    # an attention output is written into the bf16 K/V cache and every
    # later bf16 op rounds again, so differences grow through the layers
    # and steps to about three ulps (0.047 measured, ulp 0.0156 at
    # magnitude 2-4); 0.1 bounds that with room for another cuBLAS
    # version, and fp32 is the tight check of the kernel's path
    for dtype, first_atol, atol in ((torch.float32, 1e-5, 1e-5),
                                    (torch.bfloat16, 1e-2, 1e-1)):
        dec = KVDecoder(params, num_layers=cfg["num_layers"],
                        num_heads=cfg["num_heads"], max_len=MAX_LEN,
                        dtype=dtype)
        ref_pg = PagedSlots(dec, 3, block=BLOCK, prefill_buckets=buckets,
                            kernel="gather")
        ref, fed = _drive(ref_pg, V)
        del ref_pg
        ker_pg = PagedSlots(dec, 3, block=BLOCK, prefill_buckets=buckets,
                            kernel="auto")
        if ker_pg.kernel != "cuda":
            raise AssertionError(f"auto picked {ker_pg.kernel!r}")
        got, _ = _drive(ker_pg, V, forced=fed)
        errs = [float(np.abs(a - b).max()) for a, b in zip(ref, got)]
        err = max(errs)
        scale = max(float(np.abs(a).max()) for a in ref)
        log(f"[parity] {str(dtype).replace('torch.', '')}: {len(ref)} "
            f"emissions, max |kernel - gather| logits {err:.3g} "
            f"(atol {atol}; first step {errs[1]:.3g}, atol {first_atol}; "
            f"max |logit| {scale:.3g}); per emission "
            f"{' '.join(f'{e:.2g}' for e in errs)}")
        if not errs[1] <= first_atol:
            raise AssertionError(f"first kernel step: logits differ by "
                                 f"{errs[1]} > {first_atol} in {dtype}")
        if not err <= atol:
            raise AssertionError(f"teacher-forced logits differ by {err} > "
                                 f"{atol} in {dtype}")
        del dec, ker_pg
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 5
def _pin_lax(symbol):
    """The graph with every FlashAttention node pinned to the dense path
    (``impl="lax"``: ``full_attention``, no kernel)."""
    for node in symbol.nodes:
        if node.op == "FlashAttention":
            node.attrs["impl"] = "lax"
    return symbol


def _rel_err(a, b):
    """||a - b|| / ||b|| in fp32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def phase_train():
    """The training slice at full width: parity step, timed steps,
    profile.  Returns the flash kernels' launches in the timed run and
    the step's numbers (tokens/s, MFU, device ms by flash kernel)."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.convert import load_trainer_params
    from mxnet_tpu_torch.models import transformer as tr
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.trainer import FusedTrainer

    cfg = tr.MFU_HEADLINE_CONFIG
    B, T, V, L = TRAIN_BATCH, cfg["seq_len"], cfg["vocab_size"], \
        cfg["num_layers"]

    def trainer(symbol):
        return FusedTrainer(symbol, optimizer="adam",
                            optimizer_params={"lr": 1e-4},
                            dtype="bfloat16").init(data=(B, T),
                                                   softmax_label=(B, T))

    mxrandom.seed(0)
    t0 = time.perf_counter()
    tk = trainer(tr.transformer_lm(**cfg))
    n_par = sum(p.numel() for p in tk.params.values())
    rng = np.random.default_rng(0)
    data = rng.integers(0, V, (B, T)).astype(np.float32)
    label = rng.integers(0, V, (B, T)).astype(np.float32)
    lab = torch.from_numpy(label).reshape(-1).long().to(tk.device)
    log(f"[train] {n_par / 1e9:.3f} B params, bf16 compute / fp32 masters, "
        f"Adam lr 1e-4, batch {B} x {T}, built in "
        f"{time.perf_counter() - t0:.1f} s")

    # parity: one step with the dense attention from the same weights,
    # then the kernel trainer's first step (which also warms it up)
    tl = trainer(_pin_lax(tr.transformer_lm(**cfg)))
    load_trainer_params(tl, tk.params)
    fa.reset_launch_counts()
    out_l = tl.step(data=data, softmax_label=label)[0]
    if any(fa.launch_counts().values()):
        raise AssertionError(f"the lax step launched flash kernels: "
                             f"{fa.launch_counts()}")
    m_l = {k: st[0] for k, st in tl.opt_state.items()}
    del tl
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out_k = tk.step(data=data, softmax_label=label)[0]
    torch.cuda.synchronize()
    log(f"[train] first kernel step (build + warm-up) "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms; launches "
        f"{fa.launch_counts()}")
    # tolerances (bf16): the kernel path keeps bf16 activations all the
    # way; the dense path's attention returns fp32 (the JAX package's
    # promotion), so every later layer of that step runs in fp32.  The
    # two differ by bf16 roundings of activations, a few 2^-9 relative
    # per op through 8 layers: outputs (probabilities near 1/32768) to
    # 1e-2 relative norm, each parameter's first moment (0.1 * the
    # gradient) to 5e-2; a wrong mask or a dropped tile moves them by
    # tens of percent.  The key biases are left out: their gradient is 0
    # in exact arithmetic (softmax ignores a shift common to a row), so
    # both sides hold rounding noise only.
    out_err = _rel_err(out_k, out_l)
    m_errs = sorted(((_rel_err(tk.opt_state[k][0], m_l[k]), k)
                     for k in m_l if not k.endswith("_k_bias")),
                    reverse=True)
    log(f"[train] parity kernel step vs lax step, same weights: softmax "
        f"output rel err {out_err:.3g} (tol 1e-2), max |diff| "
        f"{float((out_k.float() - out_l.float()).abs().max()):.3g}; Adam "
        f"first moment rel err max {m_errs[0][0]:.3g} ({m_errs[0][1]}; tol "
        f"5e-2), median {m_errs[len(m_errs) // 2][0]:.3g}")
    if not out_err <= 1e-2:
        raise AssertionError(f"kernel vs lax softmax output rel err "
                             f"{out_err}")
    if not m_errs[0][0] <= 5e-2:
        raise AssertionError(f"kernel vs lax Adam first moment rel err "
                             f"{m_errs[0]}")
    del out_l, m_l, out_k
    torch.cuda.empty_cache()

    # the main path's run: every kernel count starts at 0 here
    torch.cuda.reset_peak_memory_stats()
    ces = []
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        p = tk.step(data=data, softmax_label=label)[0]
        ces.append(-torch.log(p[torch.arange(B * T, device=p.device), lab]
                              .float().clamp_min(1e-30)).mean())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launch_counts()
    finite = bool(torch.isfinite(p).all())
    ces = torch.stack(ces).cpu().tolist()
    peak = torch.cuda.max_memory_allocated()
    want = L * TRAIN_STEPS
    if launches != {k: want for k in launches}:
        raise AssertionError(f"flash launches {launches} in {TRAIN_STEPS} "
                             f"steps; want {L} per step each")
    if not finite or not all(math.isfinite(c) for c in ces):
        raise AssertionError(f"non-finite outputs or loss: {ces}")
    if not ces[-1] < ces[0]:
        raise AssertionError(f"cross-entropy did not fall: {ces}")
    step_ms = wall / TRAIN_STEPS * 1e3
    tok_s = B * T * TRAIN_STEPS / wall
    fpt = tr.lm_train_flops_per_token(L, cfg["d_model"], cfg["d_ff"], T, V)
    log(f"[train] {TRAIN_STEPS} steps: {tok_s:.1f} tokens/s, step "
        f"{step_ms:.2f} ms, MFU {tok_s * fpt / PEAK_FLOPS[torch.bfloat16]:.4f}"
        f" ({fpt / 1e9:.3f} GFLOP/token over 989 TFLOP/s bf16); "
        f"cross-entropy {' '.join(f'{c:.4f}' for c in ces)}; launches "
        f"{launches} (= {L} per step each); peak memory "
        f"{peak / 2**30:.2f} GiB")
    prof = train_profile(tk, data, label, step_ms)
    prof.update(tokens_per_s=tok_s,
                mfu=tok_s * fpt / PEAK_FLOPS[torch.bfloat16])
    del tk
    torch.cuda.empty_cache()
    return launches, prof


def train_profile(tk, data, label, step_ms, steps=2):
    """Device time per kernel name over ``steps`` training steps
    (torch.profiler, CUDA activity); idle share = 1 - device busy / the
    timed steps' wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            tk.step(data=data, softmax_label=label)
        torch.cuda.synchronize()
    rows = _device_ms(prof, steps)
    busy = sum(t for t, _ in rows)
    # device time by kind of kernel, first matching pattern wins
    kinds = {"flash": ("flash_",), "gemm": ("nvjet", "gemm", "xmma",
                                             "cutlass"),
             "elementwise": ("elementwise",), "reduce": ("reduce",)}
    by_kind = dict.fromkeys(list(kinds) + ["other"], 0.0)
    for t, name in rows:
        kind = next((k for k, pats in kinds.items()
                     if any(p in name for p in pats)), "other")
        by_kind[kind] += t
    # the flash kernels one by one (the bf16 kernels' names are
    # flash_fwd_bf16_sm90, flash_dq_bf16_sm90 and flash_dkv_bf16_sm90)
    flash = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for t, name in rows:
        for key, pat in (("flash_fwd", "flash_fwd"),
                         ("flash_bwd_dq", "flash_dq"),
                         ("flash_bwd_dq", "flash_bwd_dq"),
                         ("flash_bwd_dkv", "flash_dkv"),
                         ("flash_bwd_dkv", "flash_bwd_dkv")):
            if pat in name:
                flash[key] += t
                break
    log(f"[train-profile] per step: {step_ms:.2f} ms wall, device busy "
        f"{busy:.2f} ms, idle share {1 - busy / step_ms:.4f}; by kind: "
        + ", ".join(f"{k} {t:.2f} ms ({t / max(busy, 1e-9):.3f})"
                    for k, t in by_kind.items())
        + "; top: " + "; ".join(f"{name[:60]} {t:.2f} ms"
                                for t, name in rows[:10]))
    log("[train-profile] flash kernels per step (8 launches each): "
        + ", ".join(f"{k} {t:.3f} ms" for k, t in flash.items())
        + f"; together {sum(flash.values()):.3f} ms of {busy:.2f} ms busy")
    return {"step_ms": step_ms, "busy_ms": busy, "flash_ms": flash}


# --------------------------------------------------------------- phase 5b
def _resnet_trainer(dtype, env=None):
    """The FusedTrainer of bench.py:1998-2005 over
    ``models.get_symbol("resnet-50", num_classes=1000)``, initialised
    from the port's seed 0 (``env``: environment knobs read at init)."""
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.trainer import FusedTrainer

    def make():
        mxrandom.seed(0)
        net = models.get_symbol("resnet-50", num_classes=1000)
        return FusedTrainer(net, optimizer="sgd", optimizer_params={
            "lr": 0.1, "momentum": 0.9, "rescale_grad": 1.0 / RESNET_BATCH},
            dtype=dtype).init(data=(RESNET_BATCH, 3, 224, 224))

    return _with_env(env or {}, make)


def _param_errs(a, b):
    """``(max, its name, median)`` over the parameters of ``||a - b|| /
    ||b||``."""
    errs = sorted((_rel_err(a.params[k], b.params[k]), k) for k in a.params)
    return errs[-1][0], errs[-1][1], errs[len(errs) // 2][0]


def _resnet_parity(staged, tag, dtype, tol, nchw=False):
    """(a) step_multi over the 4 staged batches against 4 calls of step()
    from the same state, each parameter's error relative to its norm;
    (b) one step() after both; (c, fp32) the first step channels-last
    against the same step under MXTPU_CONV_LAYOUT=NCHW.  ``tol`` is
    ``(max, median)`` over the parameters for (a) and (b).  The betas
    and the FC bias start at 0, so their norm is their update, a sum
    that cancels to a small part of its terms; the bulk of the
    parameters is held by the median."""
    from mxnet_tpu_torch.convert import load_trainer_params

    eager = _resnet_trainer(dtype)
    arg, aux = eager.get_params()
    graph = _resnet_trainer(dtype)
    load_trainer_params(graph, arg, aux)
    out = {}
    x0 = staged[0]
    if nchw:
        c = _resnet_trainer(dtype, {"MXTPU_CONV_LAYOUT": "NCHW"})
        load_trainer_params(c, arg, aux)
        if c._cl_params or len(eager._cl_params) != 53:
            raise AssertionError(f"channels-last weights: "
                                 f"{len(eager._cl_params)} (want 53) and "
                                 f"{len(c._cl_params)} under NCHW")
        oc = c.step(**x0)[0]
    want = [eager.step(**x0)[0]]
    if nchw:
        # other conv kernels for the other layout.  What depends on the
        # forward alone agrees to fp32 reassociation: the softmax on the
        # same weights and the BN moving variances, 1e-5 (measured 9.5e-7
        # and 4.9e-8 on an H100, TF32 off).  The moving means start at 0,
        # so after one step they are small cancelling sums (6.0e-5
        # apart): logged, not held.  The first SGD update is
        # ill-conditioned too: at the bench's Uniform(0.01) weights,
        # which BatchNorm makes scale-free, the gradients are ~100x the
        # weights and the update replaces them, and rounding in the
        # backward moved the updated parameters by 8.8e-4 of their norm
        # in the median and a beta by 1.7e-2.  A layout fault moves them
        # by O(1): 1e-2 in the median, 1e-1 at most
        err = _rel_err(want[0], oc)
        perr = _param_errs(eager, c)
        merr = max((_rel_err(eager.aux[k], c.aux[k]), k) for k in c.aux
                   if k.endswith("_mean"))
        verr = max((_rel_err(eager.aux[k], c.aux[k]), k) for k in c.aux
                   if k.endswith("_var"))
        ntol = NCHW_TOL
        log(f"[train_resnet-parity] fp32 one step channels-last vs NCHW: "
            f"softmax rel err {err:.3g} (tol {ntol[0]}), BN moving "
            f"variances {verr[0]:.3g} ({verr[1]}; tol {ntol[0]}), moving "
            f"means {merr[0]:.3g} ({merr[1]}), parameter rel err median "
            f"{perr[2]:.3g} (tol {ntol[1]}), max {perr[0]:.3g} ({perr[1]}; "
            f"tol {ntol[2]})")
        if not (max(err, verr[0]) <= ntol[0] and perr[2] <= ntol[1]
                and perr[0] <= ntol[2]):
            raise AssertionError(f"channels-last vs NCHW: {err}, {verr}, "
                                 f"{perr}")
        out["vs_nchw"] = {"softmax": err, "moving_var": verr[0],
                          "moving_mean": merr[0], "params_max": perr[0],
                          "params_median": perr[2]}
        del c, oc
    want += [eager.step(**b)[0] for b in staged[1:]]
    outs = graph.step_multi(**{k: torch.stack([b[k] for b in staged])
                               for k in staged[0]})
    err = _rel_err(outs[0], torch.stack(want))
    perr = _param_errs(graph, eager)
    aerr = max(_rel_err(graph.aux[k], eager.aux[k]) for k in eager.aux)
    eager.step(**x0)
    graph.step(**x0)
    cont = _param_errs(graph, eager)
    log(f"[train_resnet-parity] {tag}: step_multi(4) vs 4 x step(): "
        f"softmax rel err {err:.3g}, parameter rel err max {perr[0]:.3g} "
        f"({perr[1]}) median {perr[2]:.3g}, aux {aerr:.3g}; then one "
        f"step() each: parameter rel err max {cont[0]:.3g} ({cont[1]}) "
        f"median {cont[2]:.3g}; tol max {tol[0]}, median {tol[1]}")
    if not (max(err, perr[0], aerr, cont[0]) <= tol[0]
            and max(perr[2], cont[2]) <= tol[1]):
        raise AssertionError(f"{tag} step_multi vs step: {err}, {perr}, "
                             f"{aerr}, {cont}")
    out.update(softmax=err, params_max=perr[0], params_median=perr[2],
               aux=aerr, continued_max=cont[0], continued_median=cont[2])
    del eager, graph, outs, want
    torch.cuda.empty_cache()
    return out


def _train_profile(run, steps, step_ms, tag, update="FusedTrainer.update",
                   prefix="train_resnet", kinds=RESNET_KINDS):
    """Device ms per step by kind of kernel, busy ms, idle share (1 -
    busy / the timed steps' wall), host launch calls per step and graph
    launches, over ``run()`` (``steps`` steps), from torch.profiler.  The
    update's device time comes from the ``update`` range (eager steps
    only: a graph's kernels have no range): the kernels that start
    inside the range's span on the device; its host launch calls are
    those made inside the range on the host."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_kind = dict.fromkeys([k for k, _ in kinds] + ["other"], 0.0)
    top, other, calls, graphs = {}, {}, 0, 0
    device, spans, host_spans, launches = [], [], [], []
    for ev in prof.events():
        r = (ev.time_range.start, ev.time_range.end)
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            # the update range's span on the device, not a kernel
            (spans if ev.name == update else device).append((r, ev.name))
        elif ev.name == update:
            host_spans.append(r)
        elif ev.name in LAUNCH_CALLS:
            calls += 1
            graphs += ev.name == "cudaGraphLaunch"
            launches.append(r[0])
    update_calls = sum(any(a <= t < b for a, b in host_spans)
                       for t in launches)
    update_ms = 0.0
    for (t0, t1), name in device:
        ms = (t1 - t0) / 1e3 / steps
        kind = next((k for k, pats in kinds
                     if any(p in name for p in pats)), "other")
        by_kind[kind] += ms
        top[name] = top.get(name, 0.0) + ms
        if kind == "other":
            other[name] = other.get(name, 0.0) + ms
        if any(a <= t0 < b for a, b in (sp for sp, _ in spans)):
            update_ms += ms
    kernels = len(device)
    busy = sum(by_kind.values())
    rows = sorted(((t, n) for n, t in top.items()), reverse=True)
    others = sorted(((t, n) for n, t in other.items()), reverse=True)
    log(f"[{prefix}-profile] {tag} per step: {step_ms:.3f} ms wall, "
        f"device busy {busy:.3f} ms, idle share {1 - busy / step_ms:.4f}; "
        f"host launch calls {calls / steps:.1f} ({graphs} graph launches "
        f"in {steps} steps), {kernels / steps:.1f} kernels; optimizer "
        f"update {update_ms:.3f} ms, {update_calls / steps:.1f} host "
        f"launch calls; by kind: "
        + ", ".join(f"{k} {t:.3f}" for k, t in by_kind.items())
        + "; top: " + "; ".join(f"{n[:80]} {t:.3f}" for t, n in rows[:8])
        + "; other: " + "; ".join(f"{n[:80]} {t:.3f}" for t, n in others[:4]))
    return {"busy_ms": busy, "idle_share": 1 - busy / step_ms,
            "launch_calls_per_step": calls / steps, "graph_launches": graphs,
            "kernels_per_step": kernels / steps, "update_ms": update_ms,
            "update_launch_calls_per_step": update_calls / steps,
            "by_kind_ms": by_kind}


class _SyncCounter:
    """Within ``with``: every Tensor read to the host and every
    synchronising CUDA call (``torch.cuda.set_sync_debug_mode("warn")``)
    is counted; the async window's waits on its events are counted apart
    (``waits``).  ``mark`` (a batch-end callback) stamps the count."""

    def __init__(self):
        self.syncs, self.marks, self.stamps, self.waits = [], [], [], []

    def _counted(self, name):
        def f(*a, **kw):
            self.syncs.append(name)
            return self.originals[name](*a, **kw)
        return f

    def _window_wait(self, window):
        self.waits.append(1)
        torch.cuda.set_sync_debug_mode(0)
        try:
            self.wait_one(window)
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    def warned(self):
        return [w for w in self.caught if SYNC_WARNING in str(w.message)]

    def total(self):
        return len(self.syncs) + len(self.warned())

    def mark(self, param):
        self.marks.append(self.total())
        self.stamps.append(time.perf_counter())

    def __enter__(self):
        import warnings

        from mxnet_tpu_torch import engine

        self._warn = warnings.catch_warnings(record=True)
        self.caught = self._warn.__enter__()
        warnings.simplefilter("always")
        self.originals = {m: getattr(torch.Tensor, m) for m in SYNC_METHODS}
        for m in SYNC_METHODS:
            setattr(torch.Tensor, m, self._counted(m))
        self.wait_one = engine.AsyncWindow._wait_one
        engine.AsyncWindow._wait_one = \
            lambda window: self._window_wait(window)
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        from mxnet_tpu_torch import engine

        torch.cuda.set_sync_debug_mode(0)
        engine.AsyncWindow._wait_one = self.wait_one
        for m, f in self.originals.items():
            setattr(torch.Tensor, m, f)
        self._warn.__exit__(*exc)
        return False


def _resnet_fit(tr, smi, tag="train_resnet", **fit_kwargs):
    """One epoch of ``fit`` (of a FusedTrainer or a Module; ``fit_kwargs``
    go to it) over an NDArrayIter of 8 host batches with Accuracy and a
    Speedometer; counts the host syncs batch by batch (``_SyncCounter``)."""
    from mxnet_tpu_torch import callback, io, metric

    rs = np.random.RandomState(5)
    n = RESNET_BATCH * RESNET_FIT_BATCHES
    x = rs.uniform(0, 1, (n, 3, 224, 224)).astype(np.float32)
    y = rs.randint(0, 1000, n).astype(np.float32)
    it = io.NDArrayIter(x, y, batch_size=RESNET_BATCH)
    acc = metric.Accuracy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _SyncCounter() as sync:
        tr.fit(it, eval_metric=acc, num_epoch=1,
               batch_end_callback=[callback.Speedometer(RESNET_BATCH),
                                   sync.mark], **fit_kwargs)
    wall = time.perf_counter() - t0
    marks, caught = sync.marks, sync.warned()
    total = sync.total()
    per_batch = [b - a for a, b in zip(marks, marks[1:])]
    batch_ms = [(b - a) * 1e3 for a, b in zip([t0] + sync.stamps,
                                              sync.stamps)]
    warned = sorted({str(w.message).splitlines()[0][:120] for w in caught})
    value = acc.get_global()[1]
    log(f"[{tag}-fit] one epoch of {RESNET_FIT_BATCHES} batches of "
        f"{RESNET_BATCH} x 3 x 224 x 224 in {wall:.3f} s "
        f"({n / wall:.1f} img/s, host data uploaded by the step); "
        f"host syncs between batches {per_batch}, before the first batch's "
        f"end {marks[0]}, at the epoch boundary {total - marks[-1]} "
        f"({', '.join(sorted(set(sync.syncs)))}; sync-debug warnings "
        f"{len(caught)}: {warned}); async-window waits {len(sync.waits)}; "
        f"host ms per batch {' '.join(f'{t:.1f}' for t in batch_ms)}; "
        f"train accuracy {value:.4f}; {smi}")
    if len(marks) != RESNET_FIT_BATCHES or any(per_batch) or marks[0]:
        raise AssertionError(f"fit made host syncs per batch: {marks}")
    if not 0.0 <= value <= 1.0:
        raise AssertionError(f"fit accuracy {value}")
    return {"img_s": n / wall, "batch_ms": batch_ms,
            "syncs_per_batch": per_batch,
            "boundary_syncs": total - marks[-1],
            "window_waits": len(sync.waits)}


def phase_train_resnet(smi):
    """ResNet-50 training at full width (bench.py's headline datapoint):
    parity of the captured step on the card, the eager and captured
    routes timed and profiled, a falling loss, and fit with its host
    syncs counted.  Returns the numbers of the [train_resnet] line."""
    rs = np.random.RandomState(0)
    staged = []  # as bench.py:2013-2019 stages them
    for _ in range(4):
        staged.append({
            "data": torch.from_numpy(rs.uniform(
                0, 1, (RESNET_BATCH, 3, 224, 224)).astype(np.float32)).cuda(),
            "softmax_label": torch.from_numpy(rs.randint(
                0, 1000, RESNET_BATCH).astype(np.float32)).cuda()})
    # tolerances (max, median over the parameters): the graph replays
    # the eager step's kernels on the same inputs; they part only where
    # a kernel adds with atomics (the max pool's backward, the
    # allocator's other workspace for cuBLAS): fp32 (TF32 off) to 1e-3
    # at most (a beta's cancelling update) and 1e-5 in the median; bf16,
    # where such last bits round activations apart, to 1e-2 and 1e-3
    # cuDNN's deterministic algorithms for the parity runs: the graph
    # and the eager steps then launch the same kernels in the same
    # summation order
    torch.backends.cudnn.deterministic = True
    try:
        parity = {"fp32": _resnet_parity(staged, "fp32", None, (1e-3, 1e-5),
                                         nchw=True),
                  "bf16": _resnet_parity(staged, "bf16", "bfloat16",
                                         (1e-2, 1e-3))}
    finally:
        torch.backends.cudnn.deterministic = False

    t0 = time.perf_counter()
    tr = _resnet_trainer("bfloat16")
    log(f"[train_resnet] ResNet-50 FusedTrainer (bf16, fp32 masters, SGD "
        f"lr 0.1 momentum 0.9 rescale_grad 1/{RESNET_BATCH}) built in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{sum(p.numel() for p in tr.params.values()) / 1e6:.3f} M params, "
        f"{len(tr._cl_params)} conv weights channels-last")
    for i in range(RESNET_WARMUP):
        tr.step(**staged[i % len(staged)])
    torch.cuda.synchronize()
    routes = {}
    # eager: RESNET_STEPS calls of step()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(RESNET_STEPS):
        out = tr.step(**staged[i % len(staged)])[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    routes["eager"] = {"steps": RESNET_STEPS, "wall_s": wall,
                       "peak_bytes": torch.cuda.max_memory_allocated(),
                       "reserved_bytes": torch.cuda.max_memory_reserved()}
    # captured: step_multi at k 8, one graph replay a step
    stacked = {k: torch.stack([staged[i % len(staged)][k]
                               for i in range(RESNET_K)])
               for k in staged[0]}
    t0 = time.perf_counter()
    tr.step_multi(**stacked)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    tr.step_multi(**stacked)
    torch.cuda.synchronize()
    calls = RESNET_STEPS // RESNET_K
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(calls):
        outs = tr.step_multi(**stacked)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the graph's private pool is reserved, not allocated, between
    # replays: the reserved peak is the route's footprint
    routes["captured"] = {"steps": calls * RESNET_K, "wall_s": wall,
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          "reserved_bytes": torch.cuda.max_memory_reserved(),
                          "capture_s": capture_s}
    if not (bool(torch.isfinite(out).all())
            and bool(torch.isfinite(outs).all())):
        raise AssertionError("non-finite training outputs")
    for tag, r in routes.items():
        r["step_ms"] = r["wall_s"] / r["steps"] * 1e3
        r["img_s"] = RESNET_BATCH * r["steps"] / r["wall_s"]
        r["mfu"] = (r["img_s"] * RESNET_FLOPS_PER_IMG
                    / PEAK_FLOPS[torch.bfloat16])
        log(f"[train_resnet] {tag}: {r['img_s']:.2f} img/s, step "
            f"{r['step_ms']:.3f} ms over {r['steps']} steps, MFU "
            f"{r['mfu']:.4f} ({RESNET_FLOPS_PER_IMG / 1e9:.3f} GFLOP/img "
            f"over 989 TFLOP/s bf16), peak memory allocated "
            f"{r['peak_bytes'] / 2**30:.2f} GiB, reserved "
            f"{r['reserved_bytes'] / 2**30:.2f} GiB"
            + (f", capture {capture_s:.2f} s" if tag == "captured" else ""))
    routes["eager"]["profile"] = _train_profile(
        lambda: [tr.step(**staged[i % len(staged)]) for i in range(2)], 2,
        routes["eager"]["step_ms"], "eager")
    prof = _train_profile(lambda: tr.step_multi(**stacked), RESNET_K,
                          routes["captured"]["step_ms"], "captured")
    routes["captured"]["profile"] = prof
    if prof["graph_launches"] != RESNET_K:
        raise AssertionError(f"{prof['graph_launches']} graph launches in "
                             f"one step_multi of {RESNET_K} steps")
    if not prof["kernels_per_step"] > 100:
        raise AssertionError("the profile saw no kernels inside the graph")
    if not prof["launch_calls_per_step"] < 10:
        raise AssertionError(f"{prof['launch_calls_per_step']} host launch "
                             f"calls per captured step")
    # the training signal: one repeated batch, from the seed-0 weights
    fresh = _resnet_trainer("bfloat16")
    p = fresh.step_multi(**{k: v.expand((RESNET_K,) + v.shape)
                            for k, v in staged[0].items()})[0]
    lab = staged[0]["softmax_label"].long()
    ces = (-torch.log(p.float().gather(2, lab.expand(RESNET_K, -1)[..., None])
                      .clamp_min(1e-30)).mean((1, 2))).cpu().tolist()
    log(f"[train_resnet] cross-entropy over one repeated batch, {RESNET_K} "
        f"captured steps: {' '.join(f'{c:.4f}' for c in ces)}")
    if not (all(math.isfinite(c) for c in ces) and ces[-1] < ces[0]):
        raise AssertionError(f"cross-entropy did not fall: {ces}")
    del fresh, p
    torch.cuda.empty_cache()
    fit = _resnet_fit(tr, smi)
    del tr
    torch.cuda.empty_cache()
    cap, eag = routes["captured"], routes["eager"]
    line = {"metric": "resnet50_train_imgs_per_sec_per_chip",
            "value": cap["img_s"], "unit": "img/s",
            "device_kind": torch.cuda.get_device_name(0),
            "batch": RESNET_BATCH, "mfu": cap["mfu"],
            "steps_per_call": RESNET_K,
            "captured": {k: v for k, v in cap.items()},
            "eager": {k: v for k, v in eag.items()},
            "parity": parity, "cross_entropy": ces, "fit": fit,
            "card": smi}
    log("[train_resnet] " + json.dumps(line))
    return line


# --------------------------------------------------------------- phase 5c
def _module(net, batch, kvstore="local", arg=None, aux=None):
    """A Module of ``net`` on the card, bound for training at ``batch`` x
    3 x 224 x 224, initialised with Xavier (or from ``arg``/``aux``), with
    the SGD of bench.py's _amp_micro through ``kvstore``."""
    import mxnet_tpu_torch as mx

    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind(data_shapes=[("data", (batch, 3, 224, 224))],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(initializer=mx.init.Xavier(), arg_params=arg,
                    aux_params=aux)
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params=MODULE_OPT)
    return mod


def _batch(x, y):
    from mxnet_tpu_torch import io
    from mxnet_tpu_torch.ndarray import NDArray

    return io.DataBatch(data=[NDArray(x)], label=[NDArray(y)])


def _module_step(mod, b):
    mod.forward(b, is_train=True)
    mod.backward()
    mod.update()


def _module_state(mod):
    """``(params, momentum, aux)`` of a Module: its bound tensors and its
    updater's (or its store's updater's) momentum, by parameter name."""
    ex = mod._exec_group.execs[0]
    upd = mod._updater or mod._kvstore._updater
    mom = {name: upd.states[i].tensor
           for i, name in enumerate(mod._param_names) if i in upd.states}
    return ({k: ex.arg_dict[k] for k in mod._param_names}, mom,
            dict(ex.aux_dict))


def _rel_errs(a, b):
    """``(max, its name, median)`` of ``||a - b|| / ||b||`` over the
    names of ``b``."""
    errs = sorted((_rel_err(a[k], b[k]), k) for k in b)
    return errs[-1][0], errs[-1][1], errs[len(errs) // 2][0]


def _module_parity(net, staged):
    """At batch 32, fp32, from the same seeded weights: one Module step
    through its own updater against one ``FusedTrainer.step`` with the
    same SGD, and one Module step through ``mx.kv.create("local")`` (the
    bucketed update) against the updater's."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.trainer import FusedTrainer

    x0 = staged[0]
    b = _batch(x0["data"], x0["softmax_label"])
    mxrandom.seed(0)
    tr = FusedTrainer(net, optimizer="sgd", optimizer_params={
        "lr": MODULE_OPT["learning_rate"],
        "momentum": MODULE_OPT["momentum"],
        "rescale_grad": 1.0 / MODULE_PARITY_BATCH}).init(
            data=(MODULE_PARITY_BATCH, 3, 224, 224))
    arg, aux = tr.get_params()
    eager = _module(net, MODULE_PARITY_BATCH, arg=arg, aux=aux)
    out_t = tr.step(**x0)[0]
    _module_step(eager, b)
    out_m = eager.get_outputs()[0].tensor
    p, mom, maux = _module_state(eager)
    tmom = {k: st[0] for k, st in tr.opt_state.items()}
    res = {"vs_trainer": {
        "softmax": _rel_err(out_m, out_t), "params": _rel_errs(p, tr.params),
        "momentum": _rel_errs(mom, tmom), "aux": _rel_errs(maux, tr.aux)}}
    del tr, out_t
    torch.cuda.empty_cache()
    bucket = _module(net, MODULE_PARITY_BATCH, kvstore=mx.kv.create("local"),
                     arg=arg, aux=aux)
    _module_step(bucket, b)
    bp, bmom, baux = _module_state(bucket)
    res["bucket_vs_eager"] = {
        "softmax": _rel_err(bucket.get_outputs()[0].tensor, out_m),
        "params": _rel_errs(bp, p), "momentum": _rel_errs(bmom, mom),
        "aux": _rel_errs(baux, maux),
        "buckets": bucket._kvstore._fused.num_buckets}
    for what, r in res.items():
        tol = MODULE_TOL[what]
        log(f"[module-parity] fp32 batch {MODULE_PARITY_BATCH}, one step, "
            f"{what}: softmax rel err {r['softmax']:.3g}; parameters max "
            f"{r['params'][0]:.3g} ({r['params'][1]}) median "
            f"{r['params'][2]:.3g}; momentum max {r['momentum'][0]:.3g} "
            f"({r['momentum'][1]}); BN moving stats max {r['aux'][0]:.3g} "
            f"({r['aux'][1]}); tol max {tol[0]}, median {tol[1]}"
            + (f"; {r['buckets']} buckets" if "buckets" in r else ""))
        worst = max(r["softmax"], r["params"][0], r["momentum"][0],
                    r["aux"][0])
        if not (worst <= tol[0] and r["params"][2] <= tol[1]):
            raise AssertionError(f"module parity {what}: {r}")
    del eager, bucket
    torch.cuda.empty_cache()
    return res


def _allocator_counts():
    """The caching allocator's cudaMalloc retries (each frees the cached
    blocks after a synchronisation) and its cudaMalloc/cudaFree calls."""
    stats = torch.cuda.memory_stats()
    return {k: stats.get(k, 0) for k in ("num_alloc_retries",
                                         "num_device_alloc",
                                         "num_device_free")}


def _module_route(net, batches, kvstore, tag, smi, amp=False):
    """The timed route at batch 256: warm-up, 12 timed steps (host wall
    ending in a sync), peak memory, a profile of 2 more steps.  With
    ``amp`` (the caller set ``MODULE_AMP_ENV``) the timed steps run
    under ``torch.cuda.set_sync_debug_mode("error")`` and must leave the
    loss scaler's ``_sync_count`` as it was; the record adds the Cast
    nodes of the bound graph and the scaler's report."""
    from mxnet_tpu_torch import amp as tamp

    if amp:
        tamp.reset_scaler()
    mod = _module(net, MODULE_BATCH, kvstore=kvstore)
    for i in range(MODULE_WARMUP):
        _module_step(mod, batches[i % len(batches)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    syncs = tamp.global_scaler()._sync_count
    alloc0 = _allocator_counts()
    t0 = time.perf_counter()
    if amp:
        torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(MODULE_STEPS):
            _module_step(mod, batches[i % len(batches)])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = mod.get_outputs()[0].tensor
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"module {tag}: non-finite outputs")
    r = {"steps": MODULE_STEPS, "wall_s": wall,
         "step_ms": wall / MODULE_STEPS * 1e3,
         "img_s": MODULE_BATCH * MODULE_STEPS / wall,
         "peak_bytes": torch.cuda.max_memory_allocated(),
         "reserved_bytes": torch.cuda.max_memory_reserved(),
         "allocator": {k: v - alloc0[k]
                       for k, v in _allocator_counts().items()}}
    peak = torch.bfloat16 if amp else torch.float32
    r["mfu"] = r["img_s"] * RESNET_FLOPS_PER_IMG / PEAK_FLOPS[peak]
    fused = getattr(mod._kvstore, "_fused", None)
    r["buckets"] = fused.num_buckets if fused is not None else None
    r["keys"] = len(mod._param_names)
    what = "fp32, TF32 off"
    if amp:
        scaler = tamp.global_scaler()
        r["loop_scaler_syncs"] = scaler._sync_count - syncs
        r["scaler"] = scaler.report()
        r["cast_nodes"] = sum(n.op == "Cast" for n in
                              mod._exec_group.execs[0]._exec_symbol.nodes)
        what = (f"MXTPU_AMP=bf16, MXTPU_LOSS_SCALE=dynamic, "
                f"{r['cast_nodes']} Cast nodes, the timed steps under "
                f"set_sync_debug_mode('error') with "
                f"{r['loop_scaler_syncs']} scaler reads; scaler "
                f"{json.dumps(r['scaler'])}")
        if r["loop_scaler_syncs"] or r["scaler"]["overflow_total"]:
            raise AssertionError(f"module {tag}: {r}")
    log(f"[module] {tag}: {r['img_s']:.2f} img/s, step {r['step_ms']:.3f} "
        f"ms over {MODULE_STEPS} steps (batch {MODULE_BATCH}, {what}), "
        f"MFU {r['mfu']:.4f} of {PEAK_FLOPS[peak] / 1e12:g} TFLOP/s; peak "
        f"memory allocated {r['peak_bytes'] / 2**30:.2f} GiB, reserved "
        f"{r['reserved_bytes'] / 2**30:.2f} GiB; caching allocator in the "
        f"timed steps {r['allocator']}; {r['keys']} keys"
        + (f" in {r['buckets']} buckets" if r["buckets"] else
           " through the eager Updater") + f"; {smi}")
    r["profile"] = _train_profile(
        lambda: [_module_step(mod, batches[i % len(batches)])
                 for i in range(2)], 2, r["step_ms"], tag,
        update="Module.update", prefix="module_amp" if amp else "module")
    del mod, out
    torch.cuda.empty_cache()
    return r


def _module_score(mod, smi):
    """``Module.score`` over 2 eval batches (4 epilogue launches a
    forward), then ``Module.predict`` against the Predictor on the same
    parameters with the same graph passes (the Conv+BN fold off, as the
    Module's executor does not fold): equal probabilities."""
    from mxnet_tpu_torch import io, metric
    from mxnet_tpu_torch.ops import residual_epilogue as tre

    rs = np.random.RandomState(7)
    n = RESNET_BATCH * MODULE_SCORE_BATCHES
    xe = rs.uniform(0, 1, (n, 3, 224, 224)).astype(np.float32)
    ye = rs.randint(0, 1000, n).astype(np.float32)
    it = io.NDArrayIter(xe, ye, batch_size=RESNET_BATCH)
    n0 = tre.launch_count()
    res = mod.score(it, metric.Accuracy())
    launched = tre.launch_count() - n0
    if launched != 4 * MODULE_SCORE_BATCHES:
        raise AssertionError(f"Module.score: {launched} epilogue launches in "
                             f"{MODULE_SCORE_BATCHES} forwards; want 4 each")
    probs = mod.predict(it).asnumpy()
    # the Module's own launches: the Predictor below is the comparison
    main = tre.launch_count() - n0
    arg, aux = mod.get_params()
    p = _predictor(mod.symbol, {k: v.tensor for k, v in arg.items()},
                   {k: v.tensor for k, v in aux.items()},
                   env={"MXTPU_GRAPH_PASSES": "cse,dce,residual_epilogue"})
    want = []
    for i in range(MODULE_SCORE_BATCHES):
        p.forward(data=xe[i * RESNET_BATCH:(i + 1) * RESNET_BATCH])
        want.append(p.get_output(0))
    want = np.concatenate(want)
    err = float(np.abs(probs - want).max())
    log(f"[module-score] Module.score over {MODULE_SCORE_BATCHES} batches of "
        f"{RESNET_BATCH}: {res}, {launched} epilogue launches; "
        f"Module.predict vs the Predictor (same parameters, passes "
        f"cse,dce,residual_epilogue, no Conv+BN fold): max |prob diff| "
        f"{err:.3g} (tol {MODULE_PREDICT_TOL}); {smi}")
    if probs.shape != (n, 1000) or not err <= MODULE_PREDICT_TOL:
        raise AssertionError(f"Module.predict vs Predictor: {probs.shape}, "
                             f"{err}")
    del p
    return {"score": res, "launches": launched, "vs_predictor": err,
            "main_launches": main}


def _module_reload(mod, prefix, staged):
    """``Module.load(prefix, 1, load_optimizer_states=True)`` of what
    ``mod`` wrote takes one step; ``mod`` takes the same step."""
    import mxnet_tpu_torch as mx

    mod.save_optimizer_states(f"{prefix}-0001.states")
    loaded = mx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                context=mx.gpu(0))
    loaded.bind(data_shapes=[("data", (RESNET_BATCH, 3, 224, 224))],
                label_shapes=[("softmax_label", (RESNET_BATCH,))])
    loaded.init_optimizer(kvstore="local", optimizer="sgd",
                          optimizer_params=MODULE_OPT)
    b = _batch(staged[1]["data"], staged[1]["softmax_label"])
    for m in (mod, loaded):
        _module_step(m, b)
    a, ma, xa = _module_state(mod)
    c, mc, xc = _module_state(loaded)
    errs = {"params": _rel_errs(c, a), "momentum": _rel_errs(mc, ma),
            "aux": _rel_errs(xc, xa)}
    worst = max(e[0] for e in errs.values())
    log(f"[module-reload] Module.load({os.path.basename(prefix)!r}, 1, "
        f"load_optimizer_states=True), then one step each: parameters max "
        f"rel err {errs['params'][0]:.3g} ({errs['params'][1]}), momentum "
        f"{errs['momentum'][0]:.3g}, BN moving stats {errs['aux'][0]:.3g} "
        f"(tol {MODULE_RELOAD_TOL})")
    if not worst <= MODULE_RELOAD_TOL:
        raise AssertionError(f"reloaded module's step differs: {errs}")
    del loaded
    return {k: v[0] for k, v in errs.items()}


def phase_module_resnet(smi):
    """The Module path (``_amp_micro``'s fp32 half, bench.py:1692-1776):
    parity on the card, ResNet-50 at batch 256 through the eager Updater
    and through the bucketed kvstore update, ``fit`` with its host syncs
    counted, ``score`` with the epilogue kernel against the Predictor,
    and a checkpoint reload.  Returns the numbers of the [module] line,
    with the epilogue launches of the phase's main path."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import callback, models
    from mxnet_tpu_torch.ops import residual_epilogue as tre

    net = models.get_symbol("resnet-50", num_classes=1000,
                            image_shape=(3, 224, 224))
    rs = np.random.RandomState(0)
    staged = [{"data": torch.from_numpy(rs.uniform(
        0, 1, (RESNET_BATCH, 3, 224, 224)).astype(np.float32)).cuda(),
        "softmax_label": torch.from_numpy(rs.randint(
            0, 1000, RESNET_BATCH).astype(np.float32)).cuda()}
        for _ in range(2)]
    # cuDNN's deterministic algorithms for the comparisons: the two
    # sides then run the same kernels in the same summation order
    torch.backends.cudnn.deterministic = True
    try:
        parity = _module_parity(net, staged)
    finally:
        torch.backends.cudnn.deterministic = False
    big = [_batch(torch.from_numpy(rs.uniform(
        0, 1, (MODULE_BATCH, 3, 224, 224)).astype(np.float32)).cuda(),
        torch.from_numpy(rs.randint(0, 1000, MODULE_BATCH).astype(
            np.float32)).cuda()) for _ in range(2)]
    # the main path's run: every kernel count starts at 0 here
    tre.reset_launch_count()
    routes = {"eager": _module_route(net, big, "local", "eager Updater",
                                     smi),
              "bucketed": _module_route(net, big, mx.kv.create("local"),
                                        "bucketed kvstore", smi)}
    del big
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_module_")
    try:
        prefix = os.path.join(tmp, "resnet50")
        fmod = mx.mod.Module(net, context=mx.gpu(0))
        fit = _resnet_fit(fmod, smi, tag="module", kvstore="local",
                          optimizer="sgd", optimizer_params=MODULE_OPT,
                          initializer=mx.init.Xavier(),
                          epoch_end_callback=callback.do_checkpoint(prefix))
        n0 = tre.launch_count()
        score = _module_score(fmod, smi)
        launches = n0 + score["main_launches"]
        torch.backends.cudnn.deterministic = True
        try:
            reload = _module_reload(fmod, prefix, staged)
        finally:
            torch.backends.cudnn.deterministic = False
        del fmod
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    if launches < 4 * MODULE_SCORE_BATCHES:
        raise AssertionError(f"the Module path launched the epilogue kernel "
                             f"{launches} times")
    eag, buc = routes["eager"], routes["bucketed"]
    log(f"[module] update launch calls per step: eager Updater "
        f"{eag['profile']['update_launch_calls_per_step']:.1f} for "
        f"{eag['keys']} keys, bucketed "
        f"{buc['profile']['update_launch_calls_per_step']:.1f} for "
        f"{buc['buckets']} buckets; epilogue launches on the phase's main "
        f"path {launches}")
    line = {"metric": "resnet50_module_train_imgs_per_sec",
            "value": eag["img_s"], "unit": "img/s",
            "device_kind": torch.cuda.get_device_name(0),
            "batch": MODULE_BATCH, "dtype": "float32", "tf32": False,
            "routes": routes, "parity": parity, "fit": fit, "score": score,
            "reload": reload, "epilogue_launches": launches, "card": smi}
    log("[module] " + json.dumps(line))
    return line

# --------------------------------------------------------------- phase 5d
def _module_tensors(mod):
    """Copies of a Module's weights, momenta and moving stats by name."""
    p, mom, aux = _module_state(mod)
    return {k: {n: t.clone() for n, t in d.items()}
            for k, d in (("params", p), ("momentum", mom), ("aux", aux))}


def _module_amp_parity(net, staged):
    """Under AMP with loss scaling, batch 32, cuDNN deterministic, from
    the same Xavier weights: one step through the eager Updater (unscale
    only) and one through the bucketed update (unscale, finite flag,
    skip-step select) must be identical to the bit, softmax included.
    Then an ``inf`` in one gradient before a bucketed update: every key
    of that bucket keeps its weight and momentum to the bit (the Module's
    weights are fp32: no masters), the other buckets move, and the
    scaler reports the scale halved, one overflow and one skip."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp as tamp

    tamp.reset_scaler()
    x0 = staged[0]
    b = _batch(x0["data"], x0["softmax_label"])
    probe = _module(net, MODULE_PARITY_BATCH)
    arg, aux = probe.get_params()
    del probe
    eager = _module(net, MODULE_PARITY_BATCH, arg=arg, aux=aux)
    _module_step(eager, b)
    want = _module_tensors(eager)
    out_e = eager.get_outputs()[0].tensor.clone()
    del eager
    bucket = _module(net, MODULE_PARITY_BATCH, kvstore=mx.kv.create("local"),
                     arg=arg, aux=aux)
    _module_step(bucket, b)
    got = _module_tensors(bucket)
    got["softmax"] = {"out": bucket.get_outputs()[0].tensor}
    want["softmax"] = {"out": out_e}
    # relative error of every tensor that is not identical to the bit
    diffs = {f"{kind}:{n}": _rel_err(got[kind][n], t)
             for kind in want for n, t in want[kind].items()
             if not torch.equal(got[kind][n], t)}
    clean = tamp.global_scaler().report()
    fused = bucket._kvstore._fused
    log(f"[module_amp-parity] AMP batch {MODULE_PARITY_BATCH}, one step, "
        f"bucketed ({fused.num_buckets} buckets) vs eager Updater: "
        f"{len(want['params'])} weights, {len(want['momentum'])} momenta, "
        f"{len(want['aux'])} moving stats and the softmax; {len(diffs)} "
        f"not identical to the bit {dict(list(diffs.items())[:6])}; "
        f"scaler {json.dumps(clean)}")
    if diffs or clean["overflow_total"]:
        raise AssertionError(f"AMP bucketed vs eager: {diffs}, {clean}")
    # the overflow: inf in one gradient of the bucket with the most keys,
    # then one bucketed update
    hit = max(fused._buckets, key=lambda bk: len(bk.keys))
    names = [bucket._param_names[k] for k in hit.keys]
    bucket.forward(_batch(staged[1]["data"], staged[1]["softmax_label"]),
                   is_train=True)
    bucket.backward()
    bucket._exec_group.execs[0].grad_dict[names[0]].fill_(float("inf"))
    before = _module_tensors(bucket)
    bucket.update()
    after = _module_tensors(bucket)
    rep = tamp.global_scaler().report()
    held = all(torch.equal(before[k][n], after[k][n])
               for k in ("params", "momentum") for n in names)
    moved = sum(not torch.equal(before["params"][n], after["params"][n])
                for n in before["params"] if n not in names)
    log(f"[module_amp-overflow] inf in {names[0]}'s gradient: "
        f"its bucket's {len(names)} keys ({', '.join(names[:4])}"
        f"{', ...' if len(names) > 4 else ''}) held their weights and "
        f"momenta to the bit: {held}; {moved} weights of the other "
        f"buckets moved; scaler {json.dumps(rep)}")
    if not (held and moved and rep["scale"] == clean["scale"] / 2
            and rep["overflow_total"] == 1
            and rep["skipped_steps_total"] == 1):
        raise AssertionError(f"AMP overflow: held {held}, moved {moved}, "
                             f"{rep}")
    arg, aux = bucket.get_params()
    del bucket
    torch.cuda.empty_cache()
    return {"bucket_vs_eager_differing": len(diffs),
            "buckets": fused.num_buckets, "clean": clean,
            "overflow": {"param": names[0], "bucket_keys": names,
                         "held": held, "moved": moved, "scaler": rep}}, \
        (arg, aux)


def _module_amp_score(net, arg, aux, smi):
    """``Module.score`` under AMP at batch 32 over 2 batches: 4 epilogue
    launches a forward, each launch's output held against the plain
    version on the same inputs (``_epi_tolerance``), in the dtype the
    kernel runs at there."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io, metric
    from mxnet_tpu_torch.ops import residual_epilogue as tre

    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind(data_shapes=[("data", (RESNET_BATCH, 3, 224, 224))],
             label_shapes=[("softmax_label", (RESNET_BATCH,))],
             for_training=False)
    mod.init_params(arg_params=arg, aux_params=aux)
    rs = np.random.RandomState(7)
    n = RESNET_BATCH * MODULE_SCORE_BATCHES
    it = io.NDArrayIter(rs.uniform(0, 1, (n, 3, 224, 224)).astype(np.float32),
                        rs.randint(0, 1000, n).astype(np.float32),
                        batch_size=RESNET_BATCH)
    calls = []
    kernel = tre._cuda_fwd

    def recording(x, s, scale, bias, channel_axis):
        out = kernel(x, s, scale, bias, channel_axis)
        calls.append((x, s, scale, bias, channel_axis, out))
        return out

    n0 = tre.launch_count()
    tre._cuda_fwd = recording
    try:
        res = mod.score(it, metric.Accuracy())
    finally:
        tre._cuda_fwd = kernel
    launched = tre.launch_count() - n0
    worst, dtypes, shapes = 0.0, set(), []
    for x, s, scale, bias, ax, out in calls:
        ref = tre._plain_fwd(x, s, scale, bias, ax)
        diff = (out.float() - ref.float()).abs()
        tol = _epi_tolerance(x, s, scale, ref)
        if not bool((diff <= tol).all()):
            raise AssertionError(f"AMP epilogue {tuple(x.shape)} {x.dtype}: "
                                 f"{float(diff.max())} over its bound")
        worst = max(worst, float(diff.max()))
        dtypes.add(str(x.dtype).replace("torch.", ""))
        shapes.append(tuple(x.shape))
    log(f"[module_amp-score] Module.score under AMP over "
        f"{MODULE_SCORE_BATCHES} batches of {RESNET_BATCH}: {res}; "
        f"{launched} epilogue launches, inputs {sorted(dtypes)} at "
        f"{shapes[:4]}; each against the plain version: max |diff| "
        f"{worst:.3g} (within the per-element bound of _epi_tolerance); "
        f"{smi}")
    if launched != 4 * MODULE_SCORE_BATCHES or len(calls) != launched:
        raise AssertionError(f"Module.score under AMP: {launched} epilogue "
                             f"launches in {MODULE_SCORE_BATCHES} forwards")
    del mod
    return {"score": res, "launches": launched, "dtypes": sorted(dtypes),
            "max_abs_err": worst}


def phase_module_amp(smi, fp32):
    """The AMP half of ``_amp_micro`` (bench.py:1692-1776): the Module
    cell of ``phase_module_resnet`` under ``MXTPU_AMP=bf16`` and
    ``MXTPU_LOSS_SCALE=dynamic`` — parity of the two update routes and
    the skip-step at batch 32, both routes timed and profiled at batch
    256 with no host sync, and ``score`` through the epilogue kernel in
    the AMP graph.  ``fp32`` is ``phase_module_resnet``'s line, printed
    beside this one.  Returns the numbers of the [module_amp] line."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.ops import residual_epilogue as tre

    net = models.get_symbol("resnet-50", num_classes=1000,
                            image_shape=(3, 224, 224))
    rs = np.random.RandomState(1)
    staged = [{"data": torch.from_numpy(rs.uniform(
        0, 1, (MODULE_PARITY_BATCH, 3, 224, 224)).astype(
            np.float32)).cuda(),
        "softmax_label": torch.from_numpy(rs.randint(
            0, 1000, MODULE_PARITY_BATCH).astype(np.float32)).cuda()}
        for _ in range(2)]

    def run():
        torch.backends.cudnn.deterministic = True
        try:
            parity, (arg, aux) = _module_amp_parity(net, staged)
        finally:
            torch.backends.cudnn.deterministic = False
        big = [_batch(torch.from_numpy(rs.uniform(
            0, 1, (MODULE_BATCH, 3, 224, 224)).astype(np.float32)).cuda(),
            torch.from_numpy(rs.randint(0, 1000, MODULE_BATCH).astype(
                np.float32)).cuda()) for _ in range(2)]
        # the main path's run: every kernel count starts at 0 here
        tre.reset_launch_count()
        routes = {"eager": _module_route(net, big, "local",
                                         "AMP eager Updater", smi, amp=True),
                  "bucketed": _module_route(net, big, mx.kv.create("local"),
                                            "AMP bucketed kvstore", smi,
                                            amp=True)}
        del big
        torch.cuda.empty_cache()
        score = _module_amp_score(net, arg, aux, smi)
        return parity, routes, score, tre.launch_count()

    parity, routes, score, launches = _with_env(MODULE_AMP_ENV, run)
    torch.cuda.empty_cache()
    for route, r in routes.items():
        f, p, fp = fp32["routes"][route], r["profile"], \
            fp32["routes"][route]["profile"]
        log(f"[module_amp-vs-fp32] {route}: AMP {r['img_s']:.2f} img/s "
            f"({r['step_ms']:.3f} ms, MFU {r['mfu']:.4f} of bf16 peak), fp32 "
            f"{f['img_s']:.2f} img/s ({f['step_ms']:.3f} ms); busy "
            f"{p['busy_ms']:.3f} vs {fp['busy_ms']:.3f} ms, idle "
            f"{p['idle_share']:.4f} vs {fp['idle_share']:.4f}; launch calls "
            f"{p['launch_calls_per_step']:.1f} vs "
            f"{fp['launch_calls_per_step']:.1f} (update "
            f"{p['update_launch_calls_per_step']:.1f} vs "
            f"{fp['update_launch_calls_per_step']:.1f}); peak memory "
            f"{r['peak_bytes'] / 2**30:.2f} vs {f['peak_bytes'] / 2**30:.2f} "
            f"GiB; by kind AMP/fp32 ms: "
            + ", ".join(f"{k} {p['by_kind_ms'][k]:.3f}/"
                        f"{fp['by_kind_ms'][k]:.3f}" for k in p["by_kind_ms"])
            + f"; {smi}")
    if launches < 4 * MODULE_SCORE_BATCHES:
        raise AssertionError(f"the AMP Module path launched the epilogue "
                             f"kernel {launches} times")
    line = {"metric": "resnet50_module_amp_train_imgs_per_sec",
            "value": routes["eager"]["img_s"], "unit": "img/s",
            "device_kind": torch.cuda.get_device_name(0),
            "batch": MODULE_BATCH, "amp": MODULE_AMP_ENV, "tf32": False,
            "routes": routes, "parity": parity, "score": score,
            "epilogue_launches": launches,
            "fp32_img_s": {k: v["img_s"] for k, v in fp32["routes"].items()},
            "card": smi}
    log("[module_amp] " + json.dumps(line))
    return line

# ----------------------------------------------------------------- phase 6
def _epi_bound_ms(rows, c, dtype):
    """The least time for one call: x and s read once and the output
    written once, plus the fp32 scale and bias, over the memory rate; or
    its 3 fp32 operations per element (add, multiply, add; the ReLU is a
    select) over the fp32 CUDA-core peak — the kernel does its math in
    fp32 whatever the storage type.  Bytes win by far."""
    item = torch.tensor([], dtype=dtype).element_size()
    t_bytes = (3 * rows * c * item + 8 * c) / PEAK_BYTES_S * 1e3
    t_ops = 3 * rows * c / PEAK_FLOPS[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _epi_tolerance(x, s, scale, ref):
    """Per-element bound on |kernel - plain| (NCHW views).  fp32: the
    same IEEE operations in the same order, so bit-identical; one ulp
    (2^-23 relative) is allowed.  bf16: the plain version rounds x + s to
    bf16 before the affine (at most 2^-8 of |x + s|, times the scale),
    and each side rounds its output once (2^-8 relative each)."""
    sc = scale.reshape(1, -1, 1, 1)
    if x.dtype == torch.float32:
        return 2.0 ** -23 * ref.abs()
    t = x.float() + s.float()
    return 2.0 ** -8 * (t * sc).abs() + 2.0 ** -7 * ref.float().abs()


def epilogue_check(dtype, seed):
    """The kernel against its plain version at the four tails' shapes
    (batch 32), channels-last, with kernel / plain / bound times.  Each
    timed call finds its inputs cold in L2: the calls rotate over enough
    copies of x and s that they exceed the 50 MB L2 three times."""
    from mxnet_tpu_torch.ops import residual_epilogue as tre

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    cl = torch.channels_last
    item = torch.tensor([], dtype=dtype).element_size()
    tag = str(dtype).replace("torch.", "")
    shapes, errs = [], []
    for name, hw, c in EPI_TAILS:
        rows = PREDICT_BATCH * hw
        shape = (PREDICT_BATCH, c, int(hw ** 0.5), int(hw ** 0.5))
        copies = max(1, min(16, math.ceil(150e6 / (3 * rows * c * item))))
        xs = [torch.randn(shape, generator=g, device=dev).to(dtype)
              .contiguous(memory_format=cl) for _ in range(copies)]
        ss = [torch.randn(shape, generator=g, device=dev).to(dtype)
              .contiguous(memory_format=cl) for _ in range(copies)]
        scale = torch.rand((c,), generator=g, device=dev) + 0.5
        bias = torch.rand((c,), generator=g, device=dev) - 0.5
        got = tre._cuda_fwd(xs[0], ss[0], scale, bias, 1)
        ref = tre._plain_fwd(xs[0], ss[0], scale, bias, 1)
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs()
        bad = diff > _epi_tolerance(xs[0], ss[0], scale, ref)
        if bool(bad.any()):
            raise AssertionError(
                f"epilogue kernel check {name} {tag}: {int(bad.sum())} "
                f"values outside the stated bound; max abs err "
                f"{float(diff.max())}")
        if not got.is_contiguous(memory_format=cl):
            raise AssertionError("epilogue kernel output lost channels-last")
        err = float(diff.max())
        t_k = _time_ms(lambda i: tre._cuda_fwd(
            xs[i % copies], ss[i % copies], scale, bias, 1), 100)
        t_p = _time_ms(lambda i: tre._plain_fwd(
            xs[i % copies], ss[i % copies], scale, bias, 1), 20)
        bound, bound_by = _epi_bound_ms(rows, c, dtype)
        shapes.append({"node": name, "rows": rows, "C": c,
                       "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                       "bound_ms": bound, "bound_by": bound_by})
        errs.append(err)
        log(f"[kernel] residual_epilogue {tag} {name} ({rows} x {c}): "
            f"max_abs_err={err:.3g} (stated bound) kernel_us="
            f"{t_k * 1e3:.2f} plain_us={t_p * 1e3:.2f} bound_us="
            f"{bound * 1e3:.2f} ({bound_by}); roofline share "
            f"{bound / t_k:.4f}")
        del xs, ss, got, ref, diff, bad
    x = torch.randn((2, 256, 4, 4), device=dev).to(dtype)
    try:
        tre._cuda_fwd(x, x, torch.ones(256, device=dev),
                      torch.zeros(256, device=dev), 1)
    except Exception as exc:  # noqa: BLE001 — the refusal is the check
        if "(rows, C) view" not in str(exc):
            raise
    else:
        raise AssertionError("the epilogue kernel took an NCHW-contiguous "
                             "input")
    torch.cuda.empty_cache()
    per_forward = {k: sum(r[k] for r in shapes)
                   for k in ("ms", "plain_ms", "bound_ms")}
    return {"max_abs_err": max(errs), **per_forward, "bound_by": "bytes",
            "library_ms": None, "shapes": shapes}


def _with_env(env, fn):
    """``fn()`` with the environment variables of ``env`` set."""
    import os

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _resnet50():
    """ResNet-50 (1000 classes, 224 x 224) and seeded weights: He-normal
    convs, gamma 1, beta 0, moving mean U(-0.1, 0.1), moving variance
    U(0.75, 1.25), FC weight N(0, 0.01)."""
    from mxnet_tpu_torch.models import resnet

    net = resnet.get_symbol(num_classes=1000, num_layers=50,
                            image_shape=(3, 224, 224))
    arg, aux = resnet.random_params(
        net, seed=0, data=(PREDICT_BATCH, 3, 224, 224))
    return net, arg, aux


def _predictor(net, arg, aux, dtype=None, env=None):
    from mxnet_tpu_torch.predict import Predictor

    return _with_env(env or {}, lambda: Predictor(
        symbol=net, arg_params=arg, aux_params=aux,
        input_shapes={"data": (PREDICT_BATCH, 3, 224, 224)}, dtype=dtype))


def predict_parity(net, arg, aux, x):
    """The Predictor with the kernel against the same graph with the
    four epilogues pinned to the plain version, and against the passes
    off, on the logits (a second head on ``fc1``: the softmax of these
    weights is near one-hot, logits of std ~180) and the probabilities.

    A fourth run binds under ``MXTPU_CONV_LAYOUT=NCHW``: contiguous
    tensors, so the reference's gate sends the epilogues to the plain
    version (0 launches); its logits are held to the passes-off
    tolerance (other conv algorithms, the same arithmetic otherwise).

    Tolerances.  fp32, kernel vs pinned: the kernel and the plain
    version are bit-identical in fp32 (`_epi_tolerance`), so the two
    Predictors run the same arithmetic: 1e-6 relative (norm) on the
    logits.  fp32, passes on vs off: the fold moves each BatchNorm into
    the conv weights (a reassociation, a few fp32 ulps per layer over
    50 layers): 1e-4 relative.  bf16: the kernel adds x + s in fp32
    where the plain version rounds it to bf16 first (one bf16 rounding,
    2^-8, at four places), and every later bf16 op rounds again; with
    the passes off, 33 BatchNorms round separately: 5e-2 relative
    (about 12 roundings of 2^-8) on the logits either way."""
    from mxnet_tpu_torch.ops import residual_epilogue as tre
    from mxnet_tpu_torch.symbol import Group, Symbol

    fc1 = next(n for n in net.nodes if n.name == "fc1")
    both = Group([net, Symbol([(fc1, 0)])])
    out = {}
    for dtype, tag, tol_pin, tol_off in ((None, "fp32", 1e-6, 1e-4),
                                         ("bfloat16", "bf16", 5e-2, 5e-2)):
        runs = {}
        # the pinned run edits its executor's post-pass graph in place,
        # so it binds without the program cache: it must not share (and
        # leave pinned) the entry the kernel runs bind through
        for kind, env in (("kernel", {}),
                          ("pinned", {"MXTPU_PROGRAM_CACHE": "0"}),
                          ("off", {"MXTPU_GRAPH_PASSES": "0"}),
                          ("nchw", {"MXTPU_CONV_LAYOUT": "NCHW"})):
            p = _predictor(both, arg, aux, dtype, env)
            if kind == "pinned":
                for node in p._exec._exec_symbol.nodes:
                    if node.op == "_residual_epilogue_bn":
                        node.attrs["impl"] = "lax"
            n0 = tre.launch_count()
            p.forward(data=x)
            runs[kind] = [torch.from_numpy(p.get_output(i)) for i in (0, 1)]
            launched = tre.launch_count() - n0
            if launched != (4 if kind == "kernel" else 0):
                raise AssertionError(f"{tag} {kind}: {launched} epilogue "
                                     "launches in one forward")
            del p
            torch.cuda.empty_cache()
        for kind, outs in runs.items():
            if not all(bool(torch.isfinite(o).all()) for o in outs):
                raise AssertionError(f"{tag} {kind}: non-finite outputs")
        pin = _rel_err(runs["kernel"][1], runs["pinned"][1])
        off = _rel_err(runs["kernel"][1], runs["off"][1])
        nchw = _rel_err(runs["kernel"][1], runs["nchw"][1])
        prob = float((runs["kernel"][0] - runs["pinned"][0]).abs().max())
        agree = float((runs["kernel"][1].argmax(1) == runs["off"][1]
                       .argmax(1)).float().mean())
        log(f"[predict-parity] {tag}: logits rel err kernel vs pinned lax "
            f"{pin:.3g} (tol {tol_pin}), kernel vs passes off {off:.3g} "
            f"(tol {tol_off}), kernel vs NCHW layout {nchw:.3g} (tol "
            f"{tol_off}); max |prob diff| vs pinned {prob:.3g}; top-1 "
            f"agreement with passes off {agree:.4f}; logit std "
            f"{float(runs['kernel'][1].std()):.1f}")
        if not pin <= tol_pin:
            raise AssertionError(f"{tag}: kernel vs pinned lax logits rel "
                                 f"err {pin} > {tol_pin}")
        if not off <= tol_off:
            raise AssertionError(f"{tag}: passes on vs off logits rel err "
                                 f"{off} > {tol_off}")
        if not nchw <= tol_off:
            raise AssertionError(f"{tag}: channels-last vs NCHW logits rel "
                                 f"err {nchw} > {tol_off}")
        out[tag] = {"kernel_vs_pinned": pin, "on_vs_off": off,
                    "vs_nchw": nchw}
    return out


def _by_kind(rows):
    """Device ms by kind of kernel, the first matching pattern winning."""
    kinds = {"epilogue": ("residual_epilogue_",),
             "pooling": ("pool",),
             "conv": ("fprop", "conv", "cudnn", "implicit", "nhwc", "nchw"),
             "gemm": ("gemm", "nvjet", "cutlass", "xmma"),
             "bn/elementwise": ("elementwise", "vectorized", "unrolled"),
             "copy": ("Memcpy", "Memset", "copy")}
    by_kind = dict.fromkeys(list(kinds) + ["other"], 0.0)
    for t, name in rows:
        kind = next((k for k, pats in kinds.items()
                     if any(p in name for p in pats)), "other")
        by_kind[kind] += t
    return by_kind


def predict_profile(p, x, tag, fwd_ms, steps=3):
    """Device time per kernel kind over ``steps`` forwards + copy-outs
    (torch.profiler, CUDA activity); idle share = 1 - device busy / the
    timed calls' wall; peak memory over the same calls."""
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.ops import residual_epilogue as tre

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n0 = tre.launch_count()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            p.forward(data=x)
            p.get_output(0)
        torch.cuda.synchronize()
    launches = tre.launch_count() - n0
    peak = torch.cuda.max_memory_allocated()
    if launches != 4 * steps:
        raise AssertionError(f"{tag}: {launches} epilogue launches in "
                             f"{steps} profiled forwards")
    rows = _device_ms(prof, steps)
    busy = sum(t for t, _ in rows)
    by_kind = _by_kind(rows)
    log(f"[predict-profile] {tag} per forward: {fwd_ms:.3f} ms wall, device "
        f"busy {busy:.3f} ms, idle share {1 - busy / fwd_ms:.4f}; by kind: "
        + ", ".join(f"{k} {t:.3f} ms ({t / max(busy, 1e-9):.3f})"
                    for k, t in by_kind.items())
        + f"; peak memory {peak / 2**30:.2f} GiB; top: "
        + "; ".join(f"{name[:90]} {t:.3f} ms" for t, name in rows[:12]))
    return {"busy_ms": busy, "idle_share": 1 - busy / fwd_ms,
            "by_kind_ms": by_kind, "peak_bytes": peak}


def phase_predict():
    """The inference slice: kernel checks, parity, the timed main path
    (fp32 and bf16), the profile.  Returns (kernel records, launches)."""
    from mxnet_tpu_torch.ops import residual_epilogue as tre

    kern = {"bf16": epilogue_check(torch.bfloat16, 20),
            "fp32": epilogue_check(torch.float32, 21)}
    t0 = time.perf_counter()
    net, arg, aux = _resnet50()
    x = np.random.default_rng(3).normal(
        size=(PREDICT_BATCH, 3, 224, 224)).astype(np.float32)
    log(f"[predict] ResNet-50 symbol and seeded weights "
        f"({sum(v.size for v in arg.values()) / 1e6:.3f} M params) in "
        f"{time.perf_counter() - t0:.1f} s")
    predict_parity(net, arg, aux, x)

    preds = {}
    for tag, dtype in (("fp32", None), ("bf16", "bfloat16")):
        t0 = time.perf_counter()
        preds[tag] = _predictor(net, arg, aux, dtype)
        for _ in range(3):      # warm-up: cuDNN plans, the allocator
            preds[tag].forward(data=x)
            out = preds[tag].get_output(0)
        log(f"[predict] {tag} Predictor built and warmed up in "
            f"{time.perf_counter() - t0:.1f} s; folded "
            f"{preds[tag]._n_bn_folded} Conv+BN pairs")
    # the main path's run: every kernel count starts at 0 here
    tre.reset_launch_count()
    timed = {}
    for tag, p in preds.items():
        torch.cuda.synchronize()
        n0 = tre.launch_count()
        t0 = time.perf_counter()
        for _ in range(PREDICT_CALLS):
            p.forward(data=x)
            out = p.get_output(0)
        wall = time.perf_counter() - t0
        got = tre.launch_count() - n0
        if got != 4 * PREDICT_CALLS:
            raise AssertionError(f"{tag}: {got} epilogue launches in "
                                 f"{PREDICT_CALLS} forwards; want 4 each")
        if out.shape != (PREDICT_BATCH, 1000) or not np.isfinite(out).all():
            raise AssertionError(f"{tag}: output {out.shape} not finite")
        # rows of probabilities sum to 1: to 1e-3 in fp32; in bf16 each
        # probability is rounded (the largest, near 1, by up to 2^-9)
        row_tol = 1e-3 if tag == "fp32" else 1e-2
        if not np.allclose(out.sum(1), 1.0, atol=row_tol):
            raise AssertionError(f"{tag}: softmax rows do not sum to 1: "
                                 f"{out.sum(1)}")
        timed[tag] = wall / PREDICT_CALLS * 1e3
        log(f"[predict] {tag}: resnet50_infer_b32_imgs_per_sec "
            f"{PREDICT_BATCH * PREDICT_CALLS / wall:.2f}, forward + "
            f"get_output {timed[tag]:.3f} ms over {PREDICT_CALLS} calls, "
            f"{got} epilogue launches")
    launches = tre.launch_count()
    for tag, p in preds.items():
        prof = predict_profile(p, x, tag, timed[tag])
        # the kernel's device time inside the forward (4 launches), where
        # the host runs ahead and no launch waits for it
        kern[tag]["in_forward_ms"] = prof["by_kind_ms"]["epilogue"]
    del preds
    torch.cuda.empty_cache()
    return kern, launches


# ----------------------------------------------------------------- phase 7
def phase_checkpoint():
    """ResNet-50 at full width through a checkpoint: ``save_checkpoint``,
    then ``predict.create`` and ``Predictor(param_bytes=)`` on the card,
    fp32 and bf16, each forward held to the Predictor built from the same
    in-memory params — identical (max abs 0): same weights, same graph.
    The net carries a second head on ``fc1`` (the logits).  Returns the
    fp32 logits, the epilogue launches of the checkpoint Predictors'
    forwards and the numbers printed."""
    from mxnet_tpu_torch import model, predict
    from mxnet_tpu_torch.ops import residual_epilogue as tre
    from mxnet_tpu_torch.symbol import Group, Symbol

    net, arg, aux = _resnet50()
    fc1 = next(n for n in net.nodes if n.name == "fc1")
    both = Group([net, Symbol([(fc1, 0)])])
    n_params = sum(v.size for v in arg.values())
    x = np.random.default_rng(3).normal(
        size=(PREDICT_BATCH, 3, 224, 224)).astype(np.float32)
    shapes = {"data": (PREDICT_BATCH, 3, 224, 224)}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        prefix = os.path.join(tmp, "resnet50")
        t0 = time.perf_counter()
        model.save_checkpoint(prefix, 0, both, arg, aux)
        save_s = time.perf_counter() - t0
        pfile = f"{prefix}-0000.params"
        size = os.path.getsize(pfile)
        t0 = time.perf_counter()
        _, larg, laux = model.load_checkpoint(prefix, 0, ctx="cpu")
        read_s = time.perf_counter() - t0
        if sorted(larg) != sorted(arg) or sorted(laux) != sorted(aux):
            raise AssertionError("load_checkpoint lost or renamed params")
        del larg, laux
        with open(pfile, "rb") as f:
            blob = f.read()
        with open(f"{prefix}-symbol.json") as f:
            js = f.read()
        log(f"[checkpoint] ResNet-50 {n_params} params ({n_params / 1e6:.3f}"
            f" M): save_checkpoint {save_s:.3f} s, {size} bytes "
            f"({size / 1e6:.2f} MB); load_checkpoint to the host "
            f"{read_s:.3f} s")
        res = {"n_params": n_params, "save_s": save_s, "bytes": size,
               "read_s": read_s, "launches": 0}
        for tag, dtype in (("fp32", None), ("bf16", "bfloat16")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            by_file = predict.create(prefix, 0, shapes, dtype=dtype)
            torch.cuda.synchronize()
            create_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            by_bytes = predict.Predictor(symbol_json_str=js, param_bytes=blob,
                                         input_shapes=shapes, dtype=dtype)
            torch.cuda.synchronize()
            bytes_s = time.perf_counter() - t0
            # the main path's run (the two checkpoint Predictors): every
            # kernel count starts at 0 here
            tre.reset_launch_count()
            outs = {}
            for kind, p in (("file", by_file), ("bytes", by_bytes)):
                p.forward(data=x)
                outs[kind] = [p.get_output(i) for i in (0, 1)]
            launched = tre.launch_count()
            if launched != 8:
                raise AssertionError(f"checkpoint {tag}: {launched} epilogue "
                                     "launches in two forwards; want 4 each")
            res["launches"] += launched
            ref = _predictor(both, arg, aux, dtype)
            ref.forward(data=x)
            outs["memory"] = [ref.get_output(i) for i in (0, 1)]
            del by_file, by_bytes, ref
            torch.cuda.empty_cache()
            for kind in ("file", "bytes"):
                for i, name in ((0, "probabilities"), (1, "logits")):
                    got, want = outs[kind][i], outs["memory"][i]
                    if got.shape != want.shape or not np.isfinite(got).all():
                        raise AssertionError(f"checkpoint {tag} {kind} "
                                             f"{name}: {got.shape} or not "
                                             "finite")
                    err = float(np.abs(got - want).max())
                    if err != 0.0:
                        raise AssertionError(
                            f"checkpoint {tag} {kind}: {name} differ from "
                            f"the in-memory Predictor's by {err}")
            res[tag] = {"create_s": create_s, "param_bytes_s": bytes_s}
            log(f"[checkpoint] {tag}: predict.create {create_s:.3f} s, "
                f"Predictor(param_bytes=) {bytes_s:.3f} s; logits and "
                f"probabilities of both identical to the in-memory "
                f"Predictor's (max abs 0), 4 epilogue launches per forward; "
                f"logit std {float(outs['file'][1].std()):.1f}")
            if tag == "fp32":
                res["logits"] = outs["file"][1]
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------- phase 8
# user kernels for rtc.Rtc (CUDA C bodies), each beside its plain twin
RTC_EXP = """
    __shared__ float s_rec[10];
    s_rec[threadIdx.x] = x[threadIdx.x];
    y[threadIdx.x] = expf(s_rec[threadIdx.x]*5.0);"""
RTC_AXPY = """
    const int n = x_dims[0];
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += blockDim.x * gridDim.x)
        out[i] = 2.0f * x[i] + y[i];"""
RTC_SOFTMAX = """
    __shared__ float red[256];
    const int cols = x_dims[1];
    const float* xr = x + (size_t)blockIdx.x * cols;
    float* yr = y + (size_t)blockIdx.x * cols;
    float m = __int_as_float(0xff800000);
    for (int c = threadIdx.x; c < cols; c += blockDim.x) m = fmaxf(m, xr[c]);
    red[threadIdx.x] = m;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s)
            red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + s]);
        __syncthreads();
    }
    m = red[0];
    __syncthreads();
    float sum = 0.0f;
    for (int c = threadIdx.x; c < cols; c += blockDim.x)
        sum += expf(xr[c] - m);
    red[threadIdx.x] = sum;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
        __syncthreads();
    }
    sum = red[0];
    for (int c = threadIdx.x; c < cols; c += blockDim.x)
        yr[c] = expf(xr[c] - m) / sum;"""


def _rtc_exp_plain(x):
    return torch.exp(x * 5.0)


def _rtc_axpy_plain(x, y):
    return 2 * x + y


def _rtc_softmax_plain(x):
    e = torch.exp(x - x.max(1, keepdim=True).values)
    return e / e.sum(1, keepdim=True)


def _rtc_bound_ms(nbytes, nops):
    """Each input read once and each output written once over the memory
    rate, or the fp32 operations over the fp32 peak, the larger."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = nops / PEAK_FLOPS[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_rtc(logits, n):
    """Three user kernels compiled by NVRTC through ``rtc.Rtc`` and
    pushed with their grid and block, each against its plain twin:
    (a) MXNet's docstring example on (10,), (b) ``2x + y`` over ``n``
    floats (the ResNet-50 parameter count), (c) a row softmax over the
    (32, 1000) logits of phase 7.  Tolerances: (a) 1e-6 relative — the
    kernel's ``expf`` and torch's ``exp`` are each within 2 ulps (2.4e-7
    relative); (b) exact — ``2x`` is exact and each side rounds one add
    (an FMA of ``2x + y`` rounds once too); (c) 1e-6 absolute + 1e-6
    relative on probabilities <= 1 — the sums run in another order
    (a few ulps of 1).  Returns the kernel record's fields."""
    import torch.nn.functional as F

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.ops import _nvrtc

    nd = mx.nd
    xa = nd.zeros((10,), ctx=mx.gpu(0))
    xa[:] = 1
    ya = nd.zeros((10,), ctx=mx.gpu(0))
    ya[:] = 2
    dev = xa.context
    g = torch.Generator(device=dev).manual_seed(30)
    xb = nd.NDArray(torch.randn(n, generator=g, device=dev))
    yb = nd.NDArray(torch.randn(n, generator=g, device=dev))
    ob = nd.empty((n,), ctx=mx.gpu(0))
    xc = nd.array(logits, ctx=mx.gpu(0))
    yc = nd.zeros(xc.shape, ctx=mx.gpu(0))
    rows = xc.shape[0]
    specs = {
        "a_docstring_exp": ("abc", [("x", xa)], [("y", ya)], RTC_EXP,
                            (1, 1, 1), (10, 1, 1)),
        "b_axpy": ("axpy", [("x", xb), ("y", yb)], [("out", ob)], RTC_AXPY,
                   (math.ceil(n / 256), 1, 1), (256, 1, 1)),
        "c_row_softmax": ("row_softmax", [("x", xc)], [("y", yc)],
                          RTC_SOFTMAX, (rows, 1, 1), (256, 1, 1)),
    }
    kernels, compile_ms = {}, {}
    for key, (name, ins, outs, body, _, _) in specs.items():
        c0 = _nvrtc.compile_count()
        t0 = time.perf_counter()
        kernels[key] = rtc.Rtc(name, ins, outs, body)
        build_ms = (time.perf_counter() - t0) * 1e3
        if _nvrtc.compile_count() != c0 + 1:
            raise AssertionError(f"rtc {key}: not one NVRTC compile")
        compile_ms[key] = kernels[key].compile_ms
        log(f"[rtc] {key}: NVRTC compile {compile_ms[key]:.2f} ms for "
            f"{kernels[key].arch}, construction {build_ms:.2f} ms")
    c0 = _nvrtc.compile_count()
    again = rtc.Rtc(*specs["b_axpy"][:4])
    if _nvrtc.compile_count() != c0 or again.compile_ms is not None:
        raise AssertionError("a second Rtc of the same source recompiled")
    try:
        rtc.Rtc("bad", [("x", xa)], [("y", ya)],
                "y[0] = undefined_thing(x[0]);")
    except mx.MXNetError as exc:
        if "NVRTC failed" not in str(exc) or "undefined_thing" not in str(exc):
            raise
        nvrtc_log = str(exc).splitlines()[1:3]
    else:
        raise AssertionError("bad Rtc source compiled")
    log(f"[rtc] second construction of b_axpy: 0 NVRTC calls; bad source "
        f"raised MXNetError with NVRTC's log: {nvrtc_log}")

    # the main path's run: every kernel count starts at 0 here
    rtc.reset_launch_count()
    for key, (_, ins, outs, _, grid, block) in specs.items():
        kernels[key].push([a for _, a in ins], [a for _, a in outs], grid,
                          block)
    launches = rtc.launch_count()
    if launches != len(specs):
        raise AssertionError(f"rtc: {launches} launches for {len(specs)} "
                             "pushes")
    torch.cuda.synchronize()
    plains = {
        "a_docstring_exp": lambda: _rtc_exp_plain(xa.tensor),
        "b_axpy": lambda: _rtc_axpy_plain(xb.tensor, yb.tensor),
        "c_row_softmax": lambda: _rtc_softmax_plain(xc.tensor),
    }
    tols = {"a_docstring_exp": (0.0, 1e-6), "b_axpy": (0.0, 0.0),
            "c_row_softmax": (1e-6, 1e-6)}
    outputs = {"a_docstring_exp": ya, "b_axpy": ob, "c_row_softmax": yc}
    errs = {}
    for key, plain in plains.items():
        got, ref = outputs[key].tensor, plain()
        diff = (got - ref).abs()
        atol, rtol = tols[key]
        bad = diff > atol + rtol * ref.abs()
        if bool(bad.any()) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"rtc {key}: {int(bad.sum())} values outside "
                                 f"atol {atol} rtol {rtol}; max abs err "
                                 f"{float(diff.max())}")
        errs[key] = float(diff.max())
    if not np.allclose(yc.asnumpy().sum(1), 1.0, atol=1e-5):
        raise AssertionError("rtc softmax rows do not sum to 1")
    # (a) once more on data that is not all ones, outside the count
    xa[:] = np.linspace(-1, 1, 10, dtype=np.float32)
    kernels["a_docstring_exp"].push([xa], [ya], (1, 1, 1), (10, 1, 1))
    torch.cuda.synchronize()
    ra = _rtc_exp_plain(xa.tensor)
    if not bool(((ya.tensor - ra).abs() <= 1e-6 * ra.abs()).all()):
        raise AssertionError("rtc a_docstring_exp on linspace data")

    library = {"a_docstring_exp": None,
               "b_axpy": lambda i: torch.add(yb.tensor, xb.tensor, alpha=2.0,
                                             out=ob.tensor),
               "c_row_softmax": lambda i: torch.softmax(xc.tensor, 1)}
    lib_err = float((torch.softmax(xc.tensor, 1)
                     - _rtc_softmax_plain(xc.tensor)).abs().max())
    nb = {"a_docstring_exp": (2 * 10 * 4, 2 * 10),
          "b_axpy": (3 * 4 * n, 2 * n),
          "c_row_softmax": (2 * 4 * xc.size, 7 * xc.size)}
    records = {}
    for key, (_, ins, outs, _, grid, block) in specs.items():
        k, args_in, args_out = kernels[key], [a for _, a in ins], \
            [a for _, a in outs]
        t_k = _time_ms(lambda i: k.push(args_in, args_out, grid, block),
                       200, 10)
        t_p = _time_ms(lambda i: plains[key](), 100, 5)
        t_l = None if library[key] is None else _time_ms(library[key],
                                                         200, 10)
        bound, bound_by = _rtc_bound_ms(*nb[key])
        records[key] = {"max_abs_err": errs[key], "ms": t_k, "plain_ms": t_p,
                        "library_ms": t_l, "bound_ms": bound,
                        "bound_by": bound_by, "compile_ms": compile_ms[key],
                        "grid": list(grid), "block": list(block)}
        log(f"[kernel] rtc {key} grid {grid} block {block}: max_abs_err="
            f"{errs[key]:.3g} push_us={t_k * 1e3:.2f} plain_us="
            f"{t_p * 1e3:.2f} library_us="
            f"{'none' if t_l is None else f'{t_l * 1e3:.2f}'} bound_us="
            f"{bound * 1e3:.4f} ({bound_by}); roofline share "
            f"{bound / t_k:.4f}")
    log(f"[rtc] b_axpy over n = {n} floats (the ResNet-50 parameter "
        f"count), {3 * 4 * n / 1e6:.1f} MB moved; library = torch.add("
        f"alpha=2) and torch.softmax (differs from the plain softmax by "
        f"{lib_err:.3g}); {launches} launches on the phase's run")
    return records, launches


# ---------------------------------------------------------------- phase 9
def _graph_flops(net, data_shape):
    """Forward FLOPs per image of ``net`` at ``data_shape`` (N, C, H, W),
    counted from its convolution and FullyConnected shapes as 2 per
    multiply-add (the other ops are not counted)."""
    shapes = net._infer({"data": data_shape})
    flops = 0
    for node in net.nodes:
        if node.op == "Convolution":
            w = shapes[(node.inputs[1][0].name, "var")]
            out = shapes[(id(node), 0)]
            flops += 2 * int(np.prod(out)) * int(np.prod(w[1:]))
        elif node.op == "FullyConnected":
            w = shapes[(node.inputs[1][0].name, "var")]
            flops += 2 * data_shape[0] * int(np.prod(w))
    return flops / data_shape[0]


def _inception_trainer(dtype):
    """``models.get_symbol("inception-v3", num_classes=1000)`` through
    FusedTrainer with bench_models.py:46-67's SGD (lr 0.1, momentum 0.9,
    rescale_grad 1/32), initialised from the port's seed 0."""
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.trainer import FusedTrainer

    mxrandom.seed(0)
    net = models.get_symbol("inception-v3", num_classes=1000)
    return FusedTrainer(net, optimizer="sgd", optimizer_params={
        "lr": 0.1, "momentum": 0.9, "rescale_grad": 1.0 / INCEPTION_BATCH},
        dtype=dtype).init(data=(INCEPTION_BATCH, 3, 299, 299))


def _inception_parity(staged, tag, dtype, tol):
    """``step_multi(k)`` over the staged batches against k calls of
    ``step()`` from the same state, then one ``step()`` each; ``tol`` is
    ``(max, median)`` over the parameters' errors relative to their
    norms (as ``_resnet_parity`` holds ResNet-50)."""
    from mxnet_tpu_torch.convert import load_trainer_params

    eager = _inception_trainer(dtype)
    graph = _inception_trainer(dtype)
    load_trainer_params(graph, *eager.get_params())
    want = [eager.step(**b)[0] for b in staged]
    outs = graph.step_multi(**{k: torch.stack([b[k] for b in staged])
                               for k in staged[0]})
    err = _rel_err(outs[0], torch.stack(want))
    perr = _param_errs(graph, eager)
    aerr = max(_rel_err(graph.aux[k], eager.aux[k]) for k in eager.aux)
    eager.step(**staged[0])
    graph.step(**staged[0])
    cont = _param_errs(graph, eager)
    log(f"[train_inception-parity] {tag}: step_multi({len(staged)}) vs "
        f"{len(staged)} x step(): softmax rel err {err:.3g}, parameter rel "
        f"err max {perr[0]:.3g} ({perr[1]}) median {perr[2]:.3g}, aux "
        f"{aerr:.3g}; then one step() each: max {cont[0]:.3g} ({cont[1]}) "
        f"median {cont[2]:.3g}; tol max {tol[0]}, median {tol[1]}")
    if not (max(err, perr[0], aerr, cont[0]) <= tol[0]
            and max(perr[2], cont[2]) <= tol[1]):
        raise AssertionError(f"inception {tag} step_multi vs step: {err}, "
                             f"{perr}, {aerr}, {cont}")
    del eager, graph, outs, want
    torch.cuda.empty_cache()
    return {"softmax": err, "params_max": perr[0], "params_median": perr[2],
            "aux": aerr, "continued_max": cont[0],
            "continued_median": cont[2]}


def phase_train_inception(smi):
    """Inception-v3 training at full width (tools/bench_models.py:46-67):
    batch 32 x 3 x 299 x 299 through FusedTrainer in bf16 with fp32
    masters; step_multi(8) against 8 step() calls in fp32 and bf16; timed
    steps through step() and step_multi(8) with a profile of each; a
    falling cross-entropy over one repeated batch."""
    from mxnet_tpu_torch import models

    rs = np.random.RandomState(11)
    shape = (INCEPTION_BATCH, 3, 299, 299)
    staged = [{"data": torch.from_numpy(rs.uniform(0, 1, shape).astype(
        np.float32)).cuda(), "softmax_label": torch.from_numpy(rs.randint(
            0, 1000, INCEPTION_BATCH).astype(np.float32)).cuda()}
        for _ in range(INCEPTION_K)]
    torch.backends.cudnn.deterministic = True
    try:
        parity = {"fp32": _inception_parity(staged, "fp32", None,
                                            (1e-3, 1e-5)),
                  "bf16": _inception_parity(staged, "bf16", "bfloat16",
                                            (1e-2, 1e-3))}
    finally:
        torch.backends.cudnn.deterministic = False
    flops = 3 * _graph_flops(models.get_symbol("inception-v3"), shape)
    t0 = time.perf_counter()
    tr = _inception_trainer("bfloat16")
    log(f"[train_inception] Inception-v3 FusedTrainer (bf16, fp32 masters, "
        f"SGD lr 0.1 momentum 0.9 rescale_grad 1/{INCEPTION_BATCH}) built in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{sum(p.numel() for p in tr.params.values()) / 1e6:.3f} M params; "
        f"{flops / 1e9:.3f} GFLOP an image a training step (3 x the "
        f"forward's conv and FC multiply-adds x 2)")
    for i in range(INCEPTION_WARMUP):
        tr.step(**staged[i % INCEPTION_K])
    stacked = {k: torch.stack([b[k] for b in staged]) for k in staged[0]}
    t0 = time.perf_counter()
    tr.step_multi(**stacked)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    routes = {}
    for tag, run, steps in (
            ("eager", lambda: [tr.step(**staged[i % INCEPTION_K])
                               for i in range(INCEPTION_STEPS)],
             INCEPTION_STEPS),
            ("captured", lambda: [tr.step_multi(**stacked) for _ in range(
                INCEPTION_STEPS // INCEPTION_K)], INCEPTION_STEPS)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        r = {"steps": steps, "wall_s": wall, "step_ms": wall / steps * 1e3,
             "img_s": INCEPTION_BATCH * steps / wall,
             "peak_bytes": torch.cuda.max_memory_allocated(),
             "reserved_bytes": torch.cuda.max_memory_reserved()}
        r["mfu"] = r["img_s"] * flops / PEAK_FLOPS[torch.bfloat16]
        log(f"[train_inception] {tag}: {r['img_s']:.2f} img/s, step "
            f"{r['step_ms']:.3f} ms over {steps} steps, MFU {r['mfu']:.4f} "
            f"(of 989 TFLOP/s bf16), peak memory allocated "
            f"{r['peak_bytes'] / 2**30:.2f} GiB, reserved "
            f"{r['reserved_bytes'] / 2**30:.2f} GiB"
            + (f", capture {capture_s:.2f} s" if tag == "captured" else "")
            + f"; {smi}")
        routes[tag] = r
    routes["eager"]["profile"] = _train_profile(
        lambda: [tr.step(**staged[i]) for i in range(2)], 2,
        routes["eager"]["step_ms"], "eager", prefix="train_inception")
    prof = _train_profile(lambda: tr.step_multi(**stacked), INCEPTION_K,
                          routes["captured"]["step_ms"], "captured",
                          prefix="train_inception")
    routes["captured"]["profile"] = prof
    if prof["graph_launches"] != INCEPTION_K:
        raise AssertionError(f"{prof['graph_launches']} graph launches in "
                             f"one step_multi of {INCEPTION_K} steps")
    del tr
    torch.cuda.empty_cache()
    fresh = _inception_trainer("bfloat16")
    p = fresh.step_multi(**{k: v.expand((INCEPTION_K,) + v.shape)
                            for k, v in staged[0].items()})[0]
    lab = staged[0]["softmax_label"].long()
    ces = (-torch.log(p.float().gather(
        2, lab.expand(INCEPTION_K, -1)[..., None]).clamp_min(1e-30))
        .mean((1, 2))).cpu().tolist()
    log(f"[train_inception] cross-entropy over one repeated batch, "
        f"{INCEPTION_K} captured steps: {' '.join(f'{c:.4f}' for c in ces)}")
    if not (all(math.isfinite(c) for c in ces) and ces[-1] < ces[0]):
        raise AssertionError(f"cross-entropy did not fall: {ces}")
    del fresh, p
    torch.cuda.empty_cache()
    line = {"metric": "inception_v3_train_imgs_per_sec",
            "value": routes["captured"]["img_s"], "unit": "img/s",
            "device_kind": torch.cuda.get_device_name(0),
            "batch": INCEPTION_BATCH, "image": 299,
            "gflop_per_img": flops / 1e9, "routes": routes,
            "parity": parity, "cross_entropy": ces, "card": smi}
    log("[train_inception] " + json.dumps(line))
    return line


# --------------------------------------------------------------- phase 10
def _dropout_check():
    """``nd.Dropout`` at AlexNet's (256, 4096) on the card: the kept share
    within 4 sigma of 0.5, every kept value exactly x / 0.5, the same
    process seed the same mask and another seed another; through an
    executor the backward's mask is the forward's; eval is the
    identity."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch import random as mxrandom

    shape = (ALEXNET_BATCH, 4096)
    x = nd.array(np.random.RandomState(12).uniform(
        0.5, 1.5, shape).astype(np.float32), ctx=mx.gpu(0))
    mxrandom.seed(1)
    a = nd.Dropout(x, p=0.5).tensor
    b = nd.Dropout(x, p=0.5).tensor
    mxrandom.seed(1)
    c = nd.Dropout(x, p=0.5).tensor
    mxrandom.seed(2)
    d = nd.Dropout(x, p=0.5).tensor
    kept = a != 0
    share = float(kept.double().mean())
    sigma = math.sqrt(0.25 / kept.numel())
    exact = bool(torch.equal(a[kept], x.tensor[kept] / 0.5))
    net = mx.sym.Dropout(mx.sym.Variable("data"), p=0.5)
    exe = net.simple_bind(mx.gpu(0), data=shape)
    (out,) = exe.forward(is_train=True, data=x.tensor)
    exe.backward(torch.ones(shape, device="cuda"))
    g = exe.grad_dict["data"]
    same_mask = bool(torch.equal(g == 0, out == 0))
    (ev,) = exe.forward(is_train=False, data=x.tensor)
    rec = {"kept_share": share, "sigma": sigma, "kept_exact": exact,
           "same_seed_same_mask": bool(torch.equal(a, c)),
           "next_draw_differs": not torch.equal(a, b),
           "other_seed_differs": not torch.equal(a, d),
           "backward_mask_is_forward": same_mask,
           "eval_identity": bool(torch.equal(ev, x.tensor))}
    log(f"[module_alexnet-dropout] nd.Dropout on {shape}: {json.dumps(rec)}")
    if not (abs(share - 0.5) <= 4 * sigma and all(
            v for k, v in rec.items() if k not in ("kept_share", "sigma"))):
        raise AssertionError(f"Dropout on the card: {rec}")
    return rec


def _capture_fault_check():
    """A deliberately failed ``step_multi`` capture, then draws on the
    card (before the repair they raised "Offset increment outside graph
    capture encountered unexpectedly")."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.ops import registry
    from mxnet_tpu_torch.trainer import FusedTrainer

    net = mx.sym.Convolution(mx.sym.Variable("data"), kernel=(3, 3),
                             num_filter=8, name="c")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Flatten(net), num_hidden=10, name="fc"), name="softmax")
    tr = FusedTrainer(net, optimizer="sgd",
                      optimizer_params={"lr": 0.1}).init(data=(4, 3, 8, 8))
    flatten = registry.get("Flatten")
    plain = flatten.fn

    def syncing(ctx, x, **attrs):
        float(x.sum())  # a host sync: not capturable
        return plain(ctx, x, **attrs)

    flatten.fn = syncing
    try:
        tr.step_multi(data=torch.rand(2, 4, 3, 8, 8, device="cuda"),
                      softmax_label=torch.zeros(2, 4, device="cuda"))
    except MXNetError as exc:
        failed = "could not be captured" in str(exc)
    else:
        failed = False
    finally:
        flatten.fn = plain
    z = torch.randn(4096, device="cuda")
    ok = failed and bool(torch.isfinite(z).all()) and float(z.std()) > 0.5
    log(f"[module_alexnet-capture] a failed step_multi capture raised "
        f"MXNetError: {failed}; torch.randn on the card after it: std "
        f"{float(z.std()):.4f}")
    if not ok:
        raise AssertionError("the card's generator after a failed capture")
    return {"capture_failed": failed, "draw_std": float(z.std())}


def _alexnet_route(net, batch, kvstore, tag, smi):
    """A Module of AlexNet at ``batch`` (Xavier, SGD lr 0.01 momentum
    0.9) through ``kvstore``: warm-up, timed steps over one repeated
    batch with the cross-entropy of each, peak memory, a profile."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import random as mxrandom

    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind(data_shapes=[("data", (ALEXNET_BATCH, 3, 224, 224))],
             label_shapes=[("softmax_label", (ALEXNET_BATCH,))])
    mxrandom.seed(0)
    mod.init_params(initializer=mx.init.Xavier())
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.01,
                                         "momentum": 0.9})
    lab = batch.label[0].tensor.long()
    probs = []
    for _ in range(ALEXNET_WARMUP):
        _module_step(mod, batch)
        probs.append(mod.get_outputs()[0].tensor.clone())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(ALEXNET_STEPS):
        _module_step(mod, batch)
        probs.append(mod.get_outputs()[0].tensor.clone())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ces = [float(-torch.log(p.gather(1, lab[:, None]).clamp_min(1e-30))
                 .mean()) for p in probs]
    r = {"steps": ALEXNET_STEPS, "wall_s": wall,
         "step_ms": wall / ALEXNET_STEPS * 1e3,
         "img_s": ALEXNET_BATCH * ALEXNET_STEPS / wall,
         "peak_bytes": torch.cuda.max_memory_allocated(),
         "cross_entropy": ces}
    log(f"[module_alexnet] {tag}: {r['img_s']:.2f} img/s, step "
        f"{r['step_ms']:.3f} ms over {ALEXNET_STEPS} steps (batch "
        f"{ALEXNET_BATCH}, fp32, TF32 off), peak memory allocated "
        f"{r['peak_bytes'] / 2**30:.2f} GiB; cross-entropy over the "
        f"repeated batch {' '.join(f'{c:.4f}' for c in ces)}; {smi}")
    # Dropout makes each step's loss noisy: the last three steps' mean
    # must lie below the first three's
    if not (all(math.isfinite(c) for c in ces)
            and sum(ces[-3:]) < sum(ces[:3])):
        raise AssertionError(f"AlexNet {tag}: cross-entropy did not fall: "
                             f"{ces}")
    r["profile"] = _train_profile(
        lambda: [_module_step(mod, batch) for _ in range(2)], 2,
        r["step_ms"], tag, update="Module.update", prefix="module_alexnet")
    del mod
    torch.cuda.empty_cache()
    return r


def phase_module_alexnet(smi):
    """AlexNet training through ``mx.mod.Module`` (BASELINE.md:44-55):
    batch 256 x 3 x 224 x 224, Xavier, SGD lr 0.01 momentum 0.9, fp32
    (TF32 off), LRN and Dropout on the card in training, through the
    eager Updater and the bucketed kvstore update; Dropout's statistics
    on the card; the generator after a failed capture."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import models

    dropout = _dropout_check()
    capture = _capture_fault_check()
    net = models.get_symbol("alexnet", num_classes=1000)
    rs = np.random.RandomState(13)
    batch = _batch(torch.from_numpy(rs.uniform(0, 1, (
        ALEXNET_BATCH, 3, 224, 224)).astype(np.float32)).cuda(),
        torch.from_numpy(rs.randint(0, 1000, ALEXNET_BATCH).astype(
            np.float32)).cuda())
    routes = {"eager": _alexnet_route(net, batch, "local", "eager Updater",
                                      smi),
              "bucketed": _alexnet_route(net, batch, mx.kv.create("local"),
                                         "bucketed kvstore", smi)}
    line = {"metric": "alexnet_module_train_imgs_per_sec",
            "value": routes["eager"]["img_s"], "unit": "img/s",
            "device_kind": torch.cuda.get_device_name(0),
            "batch": ALEXNET_BATCH, "dtype": "float32", "tf32": False,
            "routes": routes, "dropout": dropout, "capture_fault": capture,
            "card": smi}
    log("[module_alexnet] " + json.dumps(line))
    return line


# --------------------------------------------------------------- phase 11
def _logits_net(net):
    """``net`` grouped with the input of its SoftmaxOutput (the logits)."""
    from mxnet_tpu_torch.symbol import Group, Symbol

    soft = net._outputs[0][0]
    return Group([net, Symbol([soft.inputs[0]])])


class _EpilogueRecorder:
    """Within ``with``, every launch of the epilogue kernel is recorded
    with its inputs and output; :meth:`check` holds each recorded launch
    against the plain version on the same inputs, then forgets them."""

    def __init__(self):
        from mxnet_tpu_torch.ops import residual_epilogue as tre

        self.tre, self.kernel, self.calls = tre, tre._cuda_fwd, []

    def _record(self, a, s, scale, bias, channel_axis):
        out = self.kernel(a, s, scale, bias, channel_axis)
        self.calls.append((a, s, scale, bias, channel_axis, out))
        return out

    def __enter__(self):
        self.tre._cuda_fwd = self._record
        return self

    def __exit__(self, *exc):
        self.tre._cuda_fwd = self.kernel
        return False

    def check(self, what):
        """The number of launches checked."""
        n, calls, self.calls = len(self.calls), self.calls, []
        for a, s, scale, bias, ax, out in calls:
            ref = self.tre._plain_fwd(a, s, scale, bias, ax)
            diff = (out.float() - ref.float()).abs()
            if not bool((diff <= _epi_tolerance(a, s, scale, ref)).all()):
                raise AssertionError(f"{what}: epilogue launch at "
                                     f"{tuple(a.shape)} {a.dtype}: max err "
                                     f"{float(diff.max())}")
        return n


def _kernel_busy(prof, steps):
    """``(kernel ms, busy ms)`` per step from a torch.profiler run: the
    sum of the kernels' durations, and the time at least one kernel ran
    (their union: cuDNN may run kernels of one call side by side)."""
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    total = sum(b - a for a, b in spans)
    union, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    return total / 1e3 / steps, union / 1e3 / steps


def phase_zoo_score(smi):
    """The inference sweep of tools/benchmark_score.py:23-56 (models at
    :62-63): each model through ``predict.Predictor`` with the passes on
    at batch 32, fp32 (TF32 off) and bf16, 20 timed forward + get_output
    calls, busy ms and idle share; fp32 logits at batch 2 against the
    port on the CPU from the same weights; every epilogue launch of the
    timed calls held against its plain version.  The epilogue launches of
    the timed calls are counted with the count reset just before them."""
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import residual_epilogue as tre
    from mxnet_tpu_torch.predict import Predictor

    rows, launches = {}, {}
    for name, side in ZOO_MODELS:
        t0 = time.perf_counter()
        net = _logits_net(models.get_symbol(name, num_classes=1000))
        shape = (ZOO_BATCH, 3, side, side)
        arg, aux = resnet.random_params(net, seed=0, data=shape)
        x = np.random.RandomState(14).uniform(-1, 1, shape).astype(
            np.float32)
        small = {"data": (2, 3, side, side)}
        cpu = Predictor(symbol=net, arg_params=arg, aux_params=aux,
                        input_shapes=small, dev_type="cpu")
        card = Predictor(symbol=net, arg_params=arg, aux_params=aux,
                         input_shapes=small)
        cpu.forward(data=x[:2])
        card.forward(data=x[:2])
        want, got = cpu.get_output(1), card.get_output(1)
        err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        del cpu, card
        if not (np.isfinite(got).all() and err <= ZOO_TOL):
            raise AssertionError(f"{name}: card logits vs CPU rel err {err}")
        row = {"side": side, "vs_cpu": err,
               "params_m": sum(v.size for v in arg.values()) / 1e6,
               "build_s": time.perf_counter() - t0}
        for tag, dtype in (("fp32", None), ("bf16", "bfloat16")):
            p = Predictor(symbol=net, arg_params=arg, aux_params=aux,
                          input_shapes={"data": shape}, dtype=dtype)
            for _ in range(3):
                p.forward(data=x)
                p.get_output(0)
            fused = sum(n.op == "_residual_epilogue_bn"
                        for n in p._exec._exec_symbol.nodes)
            # the timed calls: each ends in get_output's copy to the host,
            # and each call's epilogue launches are held against the
            # plain version after its time is taken
            wall, checked = 0.0, []
            torch.cuda.synchronize()
            tre.reset_launch_count()
            with _EpilogueRecorder() as rec:
                for _ in range(ZOO_CALLS):
                    t0 = time.perf_counter()
                    p.forward(data=x)
                    out = p.get_output(0)
                    wall += time.perf_counter() - t0
                    checked.append(rec.check(f"{name} {tag}"))
            n = tre.launch_count()
            fwd_ms = wall / ZOO_CALLS * 1e3
            if out.shape != (ZOO_BATCH, 1000) or not np.isfinite(out).all():
                raise AssertionError(f"{name} {tag}: output {out.shape}")
            if n != sum(checked) or len(set(checked)) != 1:
                raise AssertionError(f"{name} {tag}: {n} epilogue launches "
                                     f"in {ZOO_CALLS} forwards, checked "
                                     f"{checked}")
            checked = checked[0]
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    p.forward(data=x)
                    p.get_output(0)
                torch.cuda.synchronize()
            kernel_ms, busy = _kernel_busy(prof, 3)
            row[tag] = {"img_s": ZOO_BATCH * ZOO_CALLS / wall,
                        "fwd_ms": fwd_ms, "busy_ms": busy,
                        "kernel_ms": kernel_ms,
                        "idle_share": 1 - busy / fwd_ms,
                        "epilogue_per_forward": checked,
                        "fused_tails": fused, "epilogue_launches": n}
            launches[f"{name} {tag}"] = n
            del p
            torch.cuda.empty_cache()
        rows[name] = row
        gate = ""
        if name == "inception-resnet-v2":
            # its residual sums feed a ReLU with no BatchNorm between, so
            # the pass's relu(BN(add)) pattern never matches; their 320,
            # 1088 and 2080 channels would fail the C % 128 gate as well
            gate = (f" ({row['fp32']['fused_tails']} fused tails: no "
                    f"relu(BN(add)) in the net; its sums' 320, 1088 and "
                    f"2080 channels fail the C % 128 gate too)")
            if row["fp32"]["epilogue_per_forward"] or \
                    row["bf16"]["epilogue_per_forward"]:
                raise AssertionError(f"{name}: epilogue launches {row}")
        log(f"[zoo_score] {name} at batch {ZOO_BATCH} x 3 x {side}^2 "
            f"({row['params_m']:.2f} M params): "
            + "; ".join(
                f"{t} {row[t]['img_s']:.2f} img/s ({row[t]['fwd_ms']:.3f} ms "
                f"a forward, device busy {row[t]['busy_ms']:.3f}, kernel "
                f"time {row[t]['kernel_ms']:.3f}, idle "
                f"{row[t]['idle_share']:.4f})" for t in ("fp32", "bf16"))
            + f"; batch-2 fp32 logits vs the CPU rel err {err:.3g} (tol {ZOO_TOL}); epilogue launches a "
            f"forward {row['fp32']['epilogue_per_forward']} (fp32) "
            f"{row['bf16']['epilogue_per_forward']} (bf16){gate}; {smi}")
    for name in ("resnet-50", "resnet-152", "resnext-50"):
        if rows[name]["fp32"]["epilogue_per_forward"] != 4 or \
                rows[name]["bf16"]["epilogue_per_forward"] != 4:
            raise AssertionError(f"{name}: epilogue launches a forward "
                                 f"{rows[name]}")
    line = {"metric": "zoo_score_imgs_per_sec", "batch": ZOO_BATCH,
            "device_kind": torch.cuda.get_device_name(0), "models": rows,
            "epilogue_launches": launches, "card": smi}
    log("[zoo_score] " + json.dumps(line))
    return line


# --------------------------------------------------------------- phase 12
def _lstm_states():
    return [f"l{i}_init_{s}" for i in range(LSTM_LAYERS) for s in "ch"]


def _lstm_trainer(dtype, dropout=LSTM_DROPOUT, seed=0):
    """``lstm.get_symbol`` through FusedTrainer as
    tools/bench_models.py:70-102 runs it (the initial states are data),
    initialised from the port's seed ``seed``."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.models import lstm
    from mxnet_tpu_torch.trainer import FusedTrainer

    states = _lstm_states()
    mxrandom.seed(seed)
    net = lstm.get_symbol(num_classes=LSTM_VOCAB, seq_len=LSTM_SEQ,
                          num_hidden=LSTM_HIDDEN, num_embed=LSTM_HIDDEN,
                          num_lstm_layer=LSTM_LAYERS, dropout=dropout)
    return FusedTrainer(net, data_names=("data", *states), optimizer="sgd",
                        optimizer_params={"lr": 1.0,
                                          "rescale_grad": 1.0 / LSTM_BATCH},
                        dtype=dtype).init(
        data=(LSTM_BATCH, LSTM_SEQ), softmax_label=(LSTM_BATCH, LSTM_SEQ),
        **{s: (LSTM_BATCH, LSTM_HIDDEN) for s in states})


def _lstm_batches(k, seed):
    """``k`` feeds of random ids (as bench_models.py draws them) with the
    states as zeros, on the card."""
    rs = np.random.RandomState(seed)
    zeros = torch.zeros(LSTM_BATCH, LSTM_HIDDEN, device="cuda")
    shape = (LSTM_BATCH, LSTM_SEQ)
    return [{"data": torch.from_numpy(rs.randint(0, LSTM_VOCAB, shape)
                                      .astype(np.float32)).cuda(),
             "softmax_label": torch.from_numpy(rs.randint(
                 0, LSTM_VOCAB, shape).astype(np.float32)).cuda(),
             **{s: zeros for s in _lstm_states()}} for _ in range(k)]


def _lstm_parity(staged, tag, dtype, dropout):
    """``step_multi(k)`` against k ``step()`` calls from the same weights
    and the same generator state (the captured steps draw what the eager
    steps draw), then one ``step()`` each."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.convert import load_trainer_params

    tol = LSTM_TOL[tag.split()[0]]
    eager = _lstm_trainer(dtype, dropout)
    graph = _lstm_trainer(dtype, dropout)
    load_trainer_params(graph, *eager.get_params())
    mxrandom.seed(5)
    want = [eager.step(**b)[0] for b in staged]
    mxrandom.seed(5)
    outs = graph.step_multi(**{k: torch.stack([b[k] for b in staged])
                               for k in staged[0]})
    err = _rel_err(outs[0], torch.stack(want))
    bitwise = bool(torch.equal(outs[0], torch.stack(want)))
    perr = _param_errs(graph, eager)
    for t in (eager, graph):
        mxrandom.seed(6)
        t.step(**staged[0])
    cont = _param_errs(graph, eager)
    log(f"[train_lstm-parity] {tag}: step_multi({len(staged)}) vs "
        f"{len(staged)} x step() from one generator state: softmax rel err "
        f"{err:.3g} (bit-equal {bitwise}), parameter rel err max "
        f"{perr[0]:.3g} ({perr[1]}) median {perr[2]:.3g}; then one step() "
        f"each: max {cont[0]:.3g} median {cont[2]:.3g}; tol max {tol[0]}, "
        f"median {tol[1]}")
    if not (max(err, perr[0], cont[0]) <= tol[0]
            and max(perr[2], cont[2]) <= tol[1]):
        raise AssertionError(f"lstm {tag} step_multi vs step: {err}, "
                             f"{perr}, {cont}")
    del eager, graph, outs, want
    torch.cuda.empty_cache()
    return {"softmax": err, "bit_equal": bitwise, "params_max": perr[0],
            "params_median": perr[2], "continued_max": cont[0]}


def _lstm_dropout_check(staged):
    """The dropout graph through ``step_multi``: a probe around every
    Dropout node of the captured step tallies the kept elements and keeps
    the last node's mask in device buffers (the replays update them, no
    host sync); two replays must draw different masks, and the keep rate
    over 8 steps lie within 4 sigma of 0.8."""
    from mxnet_tpu_torch.ops import registry

    drop = registry.get("Dropout")
    plain = drop.fn
    kept = torch.zeros((), dtype=torch.float64, device="cuda")
    seen = torch.zeros((), dtype=torch.float64, device="cuda")
    last = torch.zeros(LSTM_BATCH, LSTM_HIDDEN, dtype=torch.bool,
                       device="cuda")

    def probe(ctx, data, **attrs):
        out = plain(ctx, data, **attrs)
        if ctx.is_train and not out.is_meta:    # not shape inference
            with torch.no_grad():
                mask = out != 0
                kept.add_(mask.sum())
                seen.add_(mask.numel())
                last.copy_(mask)
        return out

    drop.fn = probe
    try:
        tr = _lstm_trainer("bfloat16")
        one = {k: v[None] for k, v in staged[0].items()}
        tr.step_multi(**one)                   # capture (warm-ups count)
        masks = []
        for _ in range(2):
            tr.step_multi(**one)
            masks.append(last.clone())
        kept.zero_()
        seen.zero_()
        tr.step_multi(**{k: torch.stack([b[k] for b in staged])
                         for k in staged[0]})
        rate, n = float(kept / seen), float(seen)
    finally:
        drop.fn = plain
    differ = not torch.equal(masks[0], masks[1])
    sigma = math.sqrt(0.16 / n)
    nodes = sum(1 for nd in tr.symbol.nodes if nd.op == "Dropout")
    log(f"[train_lstm-dropout] step_multi captured the dropout={LSTM_DROPOUT}"
        f" graph ({nodes} Dropout nodes a step, the trainer's generator "
        f"registered with the graph): two replays drew different masks: "
        f"{differ}; keep rate over {len(staged)} replays {rate:.6f} of "
        f"{n:.0f} elements (0.8 +- {LSTM_KEEP_SIGMAS} sigma = "
        f"{LSTM_KEEP_SIGMAS * sigma:.2e})")
    if not differ or abs(rate - 0.8) > LSTM_KEEP_SIGMAS * sigma:
        raise AssertionError(f"dropout in the captured step: differ "
                             f"{differ}, keep rate {rate}")
    del tr
    torch.cuda.empty_cache()
    return {"captured": True, "masks_differ": differ, "keep_rate": rate,
            "elements": n, "sigma": sigma, "dropout_nodes": nodes}


def _lstm_cells_check(smi):
    """A FusedRNNCell 2 x 200 LSTM (the ``RNN`` op) against the unrolled
    LSTMCell stack it unpacks into, at T 35 and batch 32, fp32: outputs
    and input gradients, and the ms of a training forward + backward of
    each."""
    import mxnet_tpu_torch as mx

    T, N, H = LSTM_SEQ, LSTM_BATCH, LSTM_HIDDEN
    fused = mx.rnn.FusedRNNCell(H, num_layers=LSTM_LAYERS, prefix="lstm_")
    fnet, _ = fused.unroll(T, inputs=mx.sym.Variable("data"), layout="NTC")
    stack = mx.rnn.SequentialRNNCell()
    for i in range(LSTM_LAYERS):
        stack.add(mx.rnn.LSTMCell(H, prefix=f"lstm_l{i}_"))
    outs, _ = stack.unroll(T, inputs=mx.sym.Variable("data"), layout="NTC",
                           merge_outputs=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    states = {f"lstm_begin_state_{i}": (LSTM_LAYERS, N, H) for i in range(2)}
    fexe = fnet.simple_bind(mx.gpu(0), data=(N, T, H), **states)
    packed = fexe.arg_dict["lstm_parameters"]
    mx.init.Uniform(generator=g)("lstm_parameters", packed)
    args = fused.unpack_weights({"lstm_parameters": packed})
    uexe = outs.simple_bind(mx.gpu(0), data=(N, T, H), **{
        k: (N, H) for k in outs.list_arguments() if "begin_state" in k})
    x = torch.randn(N, T, H, generator=g, device="cuda")
    head = torch.randn(N, T, H, generator=g, device="cuda")
    times, res = {}, {}
    for tag, exe, kw in (("fused", fexe, {}), ("unrolled", uexe, args)):
        def run():
            (o,) = exe.forward(is_train=True, data=x, **kw)
            exe.backward(head)
            return o
        res[tag] = (run(), exe.grad_dict["data"].clone())
        times[tag] = _time_ms(lambda i: run(), 10, warmup=2)
    out_err = float((res["fused"][0] - res["unrolled"][0]).abs().max())
    grad_err = float((res["fused"][1] - res["unrolled"][1]).abs().max())
    log(f"[train_lstm-cells] FusedRNNCell {LSTM_LAYERS} x {H} LSTM (the RNN "
        f"op) vs the unrolled LSTMCell stack from unpack_weights, T {T} "
        f"batch {N} fp32: max |diff| output {out_err:.3g}, input gradient "
        f"{grad_err:.3g} (tol {LSTM_CELL_TOL}); training forward + "
        f"backward {times['fused']:.3f} ms fused, {times['unrolled']:.3f} "
        f"ms unrolled; {smi}")
    if max(out_err, grad_err) > LSTM_CELL_TOL:
        raise AssertionError(f"FusedRNNCell vs unrolled: {out_err}, "
                             f"{grad_err}")
    return {"max_abs_diff_output": out_err, "max_abs_diff_grad": grad_err,
            "fused_ms": times["fused"], "unrolled_ms": times["unrolled"]}


def phase_train_lstm(smi):
    """Path (a): the LSTM LM through FusedTrainer at full width (batch 32 x
    35, 2 x 200, vocab 10000, dropout 0.2, bf16 with fp32 masters, SGD lr
    1.0): step_multi(8) against 8 step() calls on the dropout=0 graph
    (fp32 and bf16) and on the dropout graph; the dropout graph captured,
    its masks fresh a replay; timed steps through step() and
    step_multi(8) with a profile each; a falling cross-entropy; the
    FusedRNNCell against the unrolled cells."""
    torch.backends.cudnn.deterministic = True
    staged = _lstm_batches(LSTM_K, 21)
    parity = {"fp32 dropout=0": _lstm_parity(staged, "fp32 dropout=0",
                                             None, 0.0),
              "bf16 dropout=0": _lstm_parity(staged, "bf16 dropout=0",
                                             "bfloat16", 0.0),
              "bf16 dropout=0.2": _lstm_parity(staged, "bf16 dropout=0.2",
                                               "bfloat16", LSTM_DROPOUT)}
    dropout = _lstm_dropout_check(staged)
    t0 = time.perf_counter()
    tr = _lstm_trainer("bfloat16")
    tokens = LSTM_BATCH * LSTM_SEQ
    log(f"[train_lstm] lstm.get_symbol FusedTrainer (bf16, fp32 masters, "
        f"SGD lr 1.0 rescale_grad 1/{LSTM_BATCH}, dropout {LSTM_DROPOUT}) "
        f"built in {time.perf_counter() - t0:.1f} s: "
        f"{sum(p.numel() for p in tr.params.values()) / 1e6:.3f} M params; "
        f"{LSTM_FLOPS_PER_TOKEN * tokens / 1e9:.2f} GFLOP a step")
    for i in range(LSTM_WARMUP):
        tr.step(**staged[i % LSTM_K])
    stacked = {k: torch.stack([b[k] for b in staged]) for k in staged[0]}
    t0 = time.perf_counter()
    tr.step_multi(**stacked)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    routes = {}
    for tag, run in (
            ("eager", lambda: [tr.step(**staged[i % LSTM_K])
                               for i in range(LSTM_STEPS)]),
            ("captured", lambda: [tr.step_multi(**stacked) for _ in range(
                LSTM_STEPS // LSTM_K)])):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        r = {"steps": LSTM_STEPS, "wall_s": wall,
             "step_ms": wall / LSTM_STEPS * 1e3,
             "tokens_s": tokens * LSTM_STEPS / wall,
             "peak_bytes": torch.cuda.max_memory_allocated()}
        r["mfu"] = r["tokens_s"] * LSTM_FLOPS_PER_TOKEN \
            / PEAK_FLOPS[torch.bfloat16]
        log(f"[train_lstm] {tag}: {r['tokens_s']:.1f} tokens/s, step "
            f"{r['step_ms']:.3f} ms over {LSTM_STEPS} steps, MFU "
            f"{r['mfu']:.5f}, peak memory allocated "
            f"{r['peak_bytes'] / 2**20:.1f} MiB"
            + (f", capture {capture_s:.2f} s" if tag == "captured" else "")
            + f"; {smi}")
        routes[tag] = r
    routes["eager"]["profile"] = _train_profile(
        lambda: [tr.step(**staged[i]) for i in range(2)], 2,
        routes["eager"]["step_ms"], "eager", prefix="train_lstm",
        kinds=LSTM_KINDS)
    prof = _train_profile(lambda: tr.step_multi(**stacked), LSTM_K,
                          routes["captured"]["step_ms"], "captured",
                          prefix="train_lstm", kinds=LSTM_KINDS)
    routes["captured"]["profile"] = prof
    if prof["graph_launches"] != LSTM_K:
        raise AssertionError(f"{prof['graph_launches']} graph launches in "
                             f"one step_multi of {LSTM_K} steps")
    del tr
    torch.cuda.empty_cache()
    # the loss over one repeated batch (the rows of lstm_unroll's output
    # are time-major: row t * N + n is label[n, t])
    fresh = _lstm_trainer("bfloat16")
    p = fresh.step_multi(**{k: v.expand((LSTM_K,) + v.shape)
                            for k, v in staged[0].items()})[0]
    lab = staged[0]["softmax_label"].t().reshape(-1).long()
    ces = (-torch.log(p.float().gather(
        2, lab.expand(LSTM_K, -1)[..., None]).clamp_min(1e-30))
        .mean((1, 2))).cpu().tolist()
    log(f"[train_lstm] cross-entropy over one repeated batch, {LSTM_K} "
        f"captured steps: {' '.join(f'{c:.4f}' for c in ces)}")
    if not (all(math.isfinite(c) for c in ces) and ces[-1] < ces[0]):
        raise AssertionError(f"cross-entropy did not fall: {ces}")
    del fresh, p
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    cells = _lstm_cells_check(smi)
    line = {"metric": "lstm_ptb_train_tokens_per_sec",
            "value": routes["captured"]["tokens_s"], "unit": "tokens/s",
            "device_kind": torch.cuda.get_device_name(0),
            "batch": LSTM_BATCH, "seq_len": LSTM_SEQ,
            "gflop_per_step": LSTM_FLOPS_PER_TOKEN * tokens / 1e9,
            "routes": routes, "parity": parity, "dropout": dropout,
            "cross_entropy": ces, "cells": cells, "card": smi}
    log("[train_lstm] " + json.dumps(line))
    return line


# --------------------------------------------------------------- phase 13
def _synthetic_corpus(num_sentences, vocab_size, seed=3):
    """examples/rnn/lstm_bucketing.py:45-57 ``synthetic_corpus`` (a copy:
    the example imports the JAX package): Zipf ids offset by one (0 is
    the padding and ignore label), lengths 5-32."""
    rs = np.random.RandomState(seed)
    ranks = np.arange(1, vocab_size + 1)
    probs = (1.0 / ranks) / (1.0 / ranks).sum()
    sentences = []
    for _ in range(num_sentences):
        length = int(rs.randint(5, 33))
        ids = rs.choice(vocab_size, size=length, p=probs) + 1
        sentences.append(ids.tolist())
    return sentences


def _time_major_perplexity():
    """``metric.Perplexity(ignore_label=0)`` with each ``(N, T)`` label
    transposed on the card to the time-major order of lstm_unroll's
    output rows (the reference's example pairs the batch-major labels
    with them as they come)."""
    from mxnet_tpu_torch import metric
    from mxnet_tpu_torch.ndarray import NDArray

    class TimeMajor(metric.Perplexity):
        def update(self, labels, preds):
            super().update([NDArray(x.tensor.t().contiguous())
                            for x in labels], preds)

    return TimeMajor(ignore_label=0)


def _bucketing_route(sentences, compile_buckets, smi):
    """Two epochs of ``BucketingModule.fit`` over ``BucketSentenceIter``
    (the lstm_bucketing example's loop), the first counted for host syncs
    batch by batch; then a profile of 4 batches."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.models.lstm import lstm_unroll

    B, H, V = LSTM_BATCH, LSTM_HIDDEN, LSTM_VOCAB
    init_states = [(f"l{i}_init_{s}", (B, H)) for i in range(LSTM_LAYERS)
                   for s in "ch"]
    it = mx.rnn.BucketSentenceIter(sentences, B, buckets=list(BUCKETS),
                                   invalid_label=0, init_states=init_states,
                                   rng=np.random.RandomState(0))
    real = sum(int((it.data[i][j:j + B] != 0).sum()) for i, j in it.idx)
    padded = sum(B * it.buckets[i] for i, _ in it.idx)

    def sym_gen(seq_len):
        net = lstm_unroll(LSTM_LAYERS, seq_len, V, H, H, V,
                          dropout=LSTM_DROPOUT, ignore_label=0)
        return net, ("data",) + tuple(n for n, _ in init_states), \
            ("softmax_label",)

    mod = mx.mod.BucketingModule(sym_gen,
                                 default_bucket_key=it.default_bucket_key,
                                 context=mx.gpu(0),
                                 compile_buckets=compile_buckets)
    mxrandom.seed(0)
    ppl, ref_ppl, walls, sync = [], [], [], None
    logger = logging.getLogger("chip_smoke.bucketing")
    logger.setLevel(logging.ERROR)
    mod.logger = logger
    for epoch in range(2):
        metric = _time_major_perplexity()
        ref = mx.metric.Perplexity(ignore_label=0)
        comp = mx.metric.CompositeEvalMetric()
        comp.add(metric)
        comp.add(ref)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _SyncCounter() as counter:
            mod.fit(it, eval_metric=comp, optimizer="sgd",
                    optimizer_params=dict(BUCKET_OPT),
                    initializer=mx.init.Xavier(factor_type="in",
                                               magnitude=2.34),
                    num_epoch=1, batch_end_callback=[
                        mx.callback.Speedometer(B, 1000), counter.mark])
        walls.append(time.perf_counter() - t0)
        if epoch == 0:
            sync = counter
        ppl.append(metric.get()[1])
        ref_ppl.append(ref.get()[1])
    per_batch = [b - a for a, b in zip(sync.marks, sync.marks[1:])]
    n = len(it.idx)
    r = {"compile_buckets": bool(compile_buckets), "batches": n,
         "real_tokens": real, "padded_tokens": padded,
         "epoch_s": walls, "real_tokens_s": [real / w for w in walls],
         "executors_bound": len(mod._buckets),
         "syncs_per_batch": per_batch, "syncs_first_batch": sync.marks[0],
         "perplexity": ppl, "perplexity_reference_pairing": ref_ppl}
    log(f"[bucketing_lstm] compile_buckets={compile_buckets}: {n} batches "
        f"an epoch ({real} real tokens of {padded} in the buckets), epochs "
        f"{' '.join(f'{w:.3f}' for w in walls)} s = "
        f"{' '.join(f'{t:.1f}' for t in r['real_tokens_s'])} real tokens/s; "
        f"executors bound {r['executors_bound']}; host syncs between "
        f"batches {sorted(set(per_batch))} (first batch {sync.marks[0]}); "
        f"perplexity (labels time-major) {' '.join(f'{v:.2f}' for v in ppl)}"
        f", as the example pairs them {' '.join(f'{v:.2f}' for v in ref_ppl)}"
        f"; {smi}")
    if len(sync.marks) != n or any(per_batch) or sync.marks[0]:
        raise AssertionError(f"BucketingModule.fit made host syncs per "
                             f"batch: {sync.marks}")
    if not (all(math.isfinite(v) for v in ppl) and ppl[1] < ppl[0]):
        raise AssertionError(f"perplexity did not fall: {ppl}")
    want = 1 if compile_buckets else len(BUCKETS)
    if len(mod._buckets) != want:
        raise AssertionError(f"{len(mod._buckets)} executors bound, want "
                             f"{want}")
    # a profile of 4 batches of the next epoch
    it.reset()
    batches = [next(it) for _ in range(4)]
    metric = mx.metric.Perplexity(ignore_label=0)

    def run():
        for b in batches:
            mod.forward_backward(b)
            mod.update()
            mod.update_metric(metric, b.label)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) / 4 * 1e3
    r["profile"] = _train_profile(run, 4, batch_ms,
                                  f"compile_buckets={compile_buckets}",
                                  update="Module.update",
                                  prefix="bucketing_lstm", kinds=LSTM_KINDS)
    r["profile"]["buckets"] = [b.bucket_key for b in batches]
    del mod
    torch.cuda.empty_cache()
    return r


def phase_bucketing_lstm(smi):
    """Path (b): examples/rnn/lstm_bucketing.py's loop through
    ``BucketingModule.fit`` over ``BucketSentenceIter`` on the example's
    Zipf corpus (vocab 10000), buckets 8/16/24/32, batch 32, 2 x 200,
    dropout 0.2, fp32 (TF32 off), with ``compile_buckets`` on and off:
    real tokens/s, executors bound, host syncs per batch (0), a falling
    perplexity, a profile."""
    sentences = _synthetic_corpus(BUCKET_SENTENCES, LSTM_VOCAB - 2)
    routes = {"compile_buckets": _bucketing_route(sentences, True, smi),
              "per_bucket": _bucketing_route(sentences, None, smi)}
    line = {"metric": "lstm_bucketing_real_tokens_per_sec",
            "value": routes["compile_buckets"]["real_tokens_s"][1],
            "unit": "tokens/s", "device_kind": torch.cuda.get_device_name(0),
            "batch": LSTM_BATCH, "buckets": list(BUCKETS),
            "routes": routes, "card": smi}
    log("[bucketing_lstm] " + json.dumps(line))
    return line


# ------------------------------------------------------------ phases 14-18
# ImageNet-style training from RecordIO (train_imagenet.py, score.py) and
# the Module path's rest (sequential_module.py, train_mnist.py)
REC_TRAIN, REC_VAL = 2560, 640
REC_SIDE = (256, 341)            # shorter side 256, 4:3
REC_QUALITY = 90
REC_BATCH = RESNET_BATCH
REC_SHAPE = (3, 224, 224)
REC_WARMUP, REC_TIMED = 2, 30    # batches of each iterator route
REC_CHECK_EVERY = 5              # the staging check's sampling
REC_MP_WORKERS = 4
REC_FIT_EPOCHS = 2
REC_K = 8                        # step_multi's steps a call
REC_RESIDENT_BATCHES = 24
REC_MODULE_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
REC_MONITOR_BATCHES, REC_MONITOR_EVERY = 41, 20
REC_STAGE_BATCHES = 4            # batches of the by-stage breakdown
SEQ_BATCH, SEQ_SAMPLES, SEQ_EPOCHS = 50, 2000, 2
MNIST_TRAIN, MNIST_TEST, MNIST_BATCH = 60000, 10000, 64
CARD = "cuda"                    # where phases 14-18 expect their batches


def _record_image(i, seed):
    """Record ``i``'s 256 x 341 RGB image: a low-frequency pattern (a few
    sinusoids a channel, drawn from its label ``i % 1000``, so a class
    has a look of its own) plus noise (drawn from ``seed`` and ``i``)."""
    pattern = np.random.RandomState(i % 1000)
    noise = np.random.RandomState(seed * 100003 + i)
    h, w = REC_SIDE
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        fx, fy = pattern.uniform(0.5, 4.0, 2)
        px, py = pattern.uniform(0, 2 * np.pi, 2)
        img[..., c] = (128 + 60 * np.sin(2 * np.pi * fx * xx + px)
                       + 50 * np.cos(2 * np.pi * fy * yy + py))
    img += noise.normal(0, 16, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def _write_records(path, n, seed):
    """``n`` seeded images through ``recordio.MXIndexedRecordIO`` and
    ``pack_img`` (JPEG q90, label ``i % 1000``), encoded on a thread
    pool; returns (mean bytes a record, seconds)."""
    from mxnet_tpu_torch import recordio

    t0 = time.perf_counter()

    def encode(i):
        header = recordio.IRHeader(0, float(i % 1000), i, 0)
        return recordio.pack_img(header, _record_image(i, seed),
                                 quality=REC_QUALITY, img_fmt=".jpg")

    w = recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    total = 0
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        for i, rec in enumerate(pool.map(encode, range(n))):
            w.write_idx(i, rec)
            total += len(rec)
    w.close()
    return total / n, time.perf_counter() - t0


def phase_records(smi, workdir):
    """The host's facts, then the training and val ``.rec`` files."""
    from mxnet_tpu_torch import image
    from mxnet_tpu_torch.ops import _build

    try:
        import PIL
        pil = f"yes ({PIL.__version__})"
    except ImportError:
        pil = "no"
    host = {"cpu_count": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0)), "pillow": pil,
            "libjpeg_links": _build.links("jpeg"), "codecs": image.codecs()}
    log(f"[records-host] {json.dumps(host)}; {smi}")
    recs = {"train": os.path.join(workdir, "train.rec"),
            "val": os.path.join(workdir, "val.rec")}
    for name, n, seed in (("train", REC_TRAIN, 0), ("val", REC_VAL, 1)):
        mean, secs = _write_records(recs[name], n, seed)
        recs[name + "_bytes"] = mean
        log(f"[records] {name}: {n} records of {REC_SIDE[0]}x{REC_SIDE[1]}"
            f" RGB, JPEG q{REC_QUALITY} through {host['codecs']['encode']},"
            f" mean {mean:.1f} bytes a record, written in {secs:.3f} s; "
            f"{smi}")
    recs["host"] = host
    return recs


class _StagingCheck:
    """Within ``with``: every ``REC_CHECK_EVERY``-th data batch staged by
    ``storage.stage_to_device`` keeps the fp64 sum of its host buffer,
    taken before staging, beside the staged tensor; :meth:`check` holds
    the fp64 sum on the card to it, bit for bit (the pixels are whole
    numbers, so both sums are exact whatever their order).  A pinned
    buffer handed out again before its copy completed breaks it."""

    def __init__(self):
        from mxnet_tpu_torch import storage

        self.storage, self.real = storage, storage.stage_to_device
        self.n, self.samples = 0, []
        self.lock = threading.Lock()

    def _stage(self, buf, device=None, stream=None):
        host = None
        if buf.dim() == 4:
            with self.lock:
                self.n += 1
                due = self.n % REC_CHECK_EVERY == 0
            if due:
                host = float(np.sum(self.storage.host_array(buf),
                                    dtype=np.float64))
        out = self.real(buf, device, stream)
        if host is not None:
            with self.lock:
                self.samples.append((host, out))
        return out

    def __enter__(self):
        self.storage.stage_to_device = self._stage
        return self

    def __exit__(self, *exc):
        self.storage.stage_to_device = self.real
        return False

    def check(self, what):
        with self.lock:
            samples, self.samples = self.samples, []
        for host, out in samples:
            got = out.double().sum().item()
            if got != host:
                raise AssertionError(f"{what}: a staged batch sums to {got} "
                                     f"on the card, {host} on the host")
        return len(samples)


def _record_iter(rec, threads, **kw):
    from mxnet_tpu_torch import image

    return image.ImageRecordIter(rec, REC_SHAPE, REC_BATCH, shuffle=True,
                                 rand_crop=True, rand_mirror=True,
                                 preprocess_threads=threads, **kw)


def _stacked(base):
    from mxnet_tpu_torch import io

    return io.DevicePrefetchIter(io.PrefetchingIter(base))


def _iter_rate(it, what):
    """Images/s of ``it`` over ``REC_TIMED`` batches after ``REC_WARMUP``,
    each consumed by a sum on the card."""
    acc = torch.zeros((), device=CARD, dtype=torch.float64)
    t0, n = None, 0
    for batch in it:
        x = batch.data[0].tensor
        if (x.device.type != CARD
                or tuple(x.shape) != (REC_BATCH,) + REC_SHAPE):
            raise AssertionError(f"{what}: batch {tuple(x.shape)} on "
                                 f"{x.device}")
        acc += x.sum(dtype=torch.float64)
        n += 1
        if n == REC_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        if n == REC_WARMUP + REC_TIMED:
            break
    torch.cuda.synchronize()
    if n != REC_WARMUP + REC_TIMED or not math.isfinite(acc.item()):
        raise AssertionError(f"{what}: {n} batches")
    return REC_TIMED * REC_BATCH / (time.perf_counter() - t0)


def _stage_breakdown(rec):
    """One thread's time a batch by stage: read (``unpack``), decode,
    augment (crop, flip), float conversion and transpose into the pooled
    buffer, and staging (the call, and the copy until it completes)."""
    from mxnet_tpu_torch import image, recordio, storage

    it = _record_iter(rec, 1)
    t = dict.fromkeys(("read", "decode", "augment", "convert",
                       "stage_call", "stage_copy"), 0.0)
    k = 0
    for _ in range(REC_STAGE_BATCHES):
        buf = storage.staging_empty((REC_BATCH,) + REC_SHAPE, np.float32,
                                    pin=CARD == "cuda")
        view = storage.host_array(buf)
        for slot in range(REC_BATCH):
            t0 = time.perf_counter()
            _, payload = recordio.unpack(it.records[it.order[k]])
            t1 = time.perf_counter()
            img = image.imdecode_np(payload)
            t2 = time.perf_counter()
            for aug in it.aug:
                img = aug(img)
            t3 = time.perf_counter()
            view[slot] = img.astype(np.float32).transpose(2, 0, 1)
            t4 = time.perf_counter()
            t["read"] += t1 - t0
            t["decode"] += t2 - t1
            t["augment"] += t3 - t2
            t["convert"] += t4 - t3
            k += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        storage.stage_to_device(buf)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t["stage_call"] += t1 - t0
        t["stage_copy"] += time.perf_counter() - t1
    return {s: v / REC_STAGE_BATCHES * 1e3 for s, v in t.items()}


def phase_record_iter(smi, recs):
    """The iterators alone at batch 32 x 3 x 224 x 224 with rand_crop and
    rand_mirror: ImageRecordIter at 1, 4 and all cores' threads, 4 mp_io
    workers, each bare and stacked as -> PrefetchingIter ->
    DevicePrefetchIter, images/s with a sum on the card as the consumer;
    every 5th staged batch held to its host buffer; one thread's time by
    stage."""
    from mxnet_tpu_torch import image

    rec, cores = recs["train"], os.cpu_count() or 1
    routes = [(f"ImageRecordIter threads={n}",
               lambda n=n: _record_iter(rec, n)) for n in (1, 4, cores)]
    routes.append((f"MultiProcessImageRecordIter workers={REC_MP_WORKERS}",
                   lambda: image.MultiProcessImageRecordIter(
                       rec, REC_SHAPE, REC_BATCH, num_workers=REC_MP_WORKERS,
                       preprocess_threads=1, shuffle=True, rand_crop=True,
                       rand_mirror=True, stall_timeout=300)))
    rates, checked = {}, 0
    with _StagingCheck() as staging:
        for name, make in routes:
            for stacked in (False, True):
                base = make()
                it = _stacked(base) if stacked else base
                tag = name + (" -> PrefetchingIter -> DevicePrefetchIter"
                              if stacked else "")
                try:
                    rates[tag] = _iter_rate(it, tag)
                finally:
                    if hasattr(base, "close"):
                        base.close()
                checked += staging.check(tag)
                log(f"[record_iter] {tag}: {rates[tag]:.1f} img/s "
                    f"({REC_TIMED} batches of {REC_BATCH} x 3 x 224 x 224 "
                    f"after {REC_WARMUP}); {smi}")
    if checked < len(rates):
        raise AssertionError(f"staging check sampled {checked} batches")
    stages = _stage_breakdown(rec)
    total = sum(stages.values())
    log(f"[record_iter-stages] one thread, ms a batch of {REC_BATCH}: "
        + ", ".join(f"{s} {v:.3f} ({v / total:.3f})"
                    for s, v in stages.items())
        + f"; {REC_BATCH * 1e3 / total:.1f} img/s; {smi}")
    log(f"[record_iter-staging] {checked} sampled staged batches equal to "
        f"their host buffers to the bit (fp64 sums); {smi}")
    return {"img_s": rates, "stages_ms": stages, "staging_checked": checked}


class _ConsumerSyncs(_SyncCounter):
    """``_SyncCounter`` counting only the reads of the thread that runs
    the loop: the pipeline's threads fill host buffers, no sync."""

    def _counted(self, name):
        consumer = threading.current_thread()

        def f(*a, **kw):
            if threading.current_thread() is consumer:
                self.syncs.append(name)
            return self.originals[name](*a, **kw)
        return f


class _Timed:
    """An iterator's ``next`` timed: the ms the loop waits on it."""

    def __init__(self, it):
        self.it, self.waits = it, []
        self.batch_size = it.batch_size
        self.provide_data, self.provide_label = (it.provide_data,
                                                 it.provide_label)

    def reset(self):
        self.it.reset()

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        try:
            return self.it.next()
        finally:
            self.waits.append((time.perf_counter() - t0) * 1e3)

    next = __next__


def _per_batch(marks, epoch=None, speedometer=None):
    """Host syncs between consecutive batch ends within each ``epoch``
    batches (the epoch boundary reads the metric), less the batches a
    ``Speedometer(frequent=speedometer)`` logs the metric on; returns
    (those counts, the Speedometer batches' counts)."""
    other, logged = [], []
    for i, (a, b) in enumerate(zip(marks, marks[1:])):
        nbatch = (i + 1) % epoch if epoch else i + 1
        if epoch and nbatch == 0:
            continue
        if speedometer and nbatch % speedometer == 0:
            logged.append(b - a)
        else:
            other.append(b - a)
    return other, logged


def _loop_report(tag, wall, n_img, steps, busy_ms, waits, sync, smi,
                 extra="", epoch=None, speedometer=None):
    """The route's line and numbers."""
    per_batch, logged = _per_batch(sync.marks, epoch, speedometer)
    if logged:
        extra += (f", the Speedometer's metric reads {sorted(set(logged))} "
                  f"on each of its {len(logged)} log batches")
    step_ms = wall / steps * 1e3
    row = {"img_s": n_img / wall, "step_ms": step_ms,
           "idle_share": 1 - busy_ms / step_ms,
           "wait_ms_per_batch": sum(waits) / max(len(waits), 1),
           "syncs_per_batch": (sum(per_batch) / len(per_batch)
                               if per_batch else 0.0)}
    log(f"[train_records] {tag}: {row['img_s']:.1f} img/s, step "
        f"{step_ms:.3f} ms, idle share {row['idle_share']:.4f} (busy "
        f"{busy_ms:.3f} ms a step), waiting on the iterator "
        f"{row['wait_ms_per_batch']:.3f} ms a batch, host syncs a batch "
        f"{row['syncs_per_batch']:.1f}{extra}; {smi}")
    if any(per_batch):
        raise AssertionError(f"{tag}: host syncs between batches "
                             f"{per_batch}")
    return row


def phase_train_records(smi, recs):
    """train_imagenet.py --fused 1 at full width: ResNet-50 bf16 with
    fp32 masters (SGD lr 0.1, momentum 0.9) at batch 32 fed from the
    records by ImageRecordIter(threads=cores) -> PrefetchingIter ->
    DevicePrefetchIter, through fit (2 epochs) and through step_multi(8)
    over step_multi_feeds (1 epoch), then step_multi fed by 4 mp_io
    workers (1 epoch); the same captured step on device-resident
    NDArrayIter data beside them."""
    from mxnet_tpu_torch import callback, io, metric

    cores = os.cpu_count() or 1
    tr = _resnet_trainer("bfloat16")
    # device-resident NDArrayIter data: the captured step's own rate
    rs = np.random.RandomState(8)
    n = REC_BATCH * REC_RESIDENT_BATCHES
    x = rs.uniform(0, 255, (n,) + REC_SHAPE).astype(np.float32)
    y = rs.randint(0, 1000, n).astype(np.float32)
    resident = list(io.DevicePrefetchIter(io.NDArrayIter(
        x, y, batch_size=REC_BATCH)))
    del x
    feeds = list(io.step_multi_feeds(resident, REC_K))
    tr.step_multi(**feeds[0])           # capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        for feed in feeds:
            tr.step_multi(**feed)
    torch.cuda.synchronize()
    resident_wall = time.perf_counter() - t0
    resident_steps = 2 * REC_RESIDENT_BATCHES
    step_ms = resident_wall / resident_steps * 1e3
    prof = _train_profile(lambda: tr.step_multi(**feeds[0]), REC_K, step_ms,
                          "step_multi(8) device-resident",
                          prefix="train_records")
    busy = prof["busy_ms"]
    rows = {"resident": {"img_s": resident_steps * REC_BATCH
                         / resident_wall, "step_ms": step_ms,
                         "idle_share": prof["idle_share"]}}
    log(f"[train_records] step_multi({REC_K}) on device-resident "
        f"NDArrayIter data: {rows['resident']['img_s']:.1f} img/s, step "
        f"{step_ms:.3f} ms, idle share {prof['idle_share']:.4f}; {smi}")
    del resident, feeds
    # fit over the records, 2 epochs
    pipe = _Timed(_stacked(_record_iter(recs["train"], cores)))
    ce = _EpochCE()
    batches = REC_TRAIN // REC_BATCH
    with _StagingCheck() as staging, _ConsumerSyncs() as sync:
        t0 = time.perf_counter()
        tr.fit(pipe, eval_metric=ce.metric, num_epoch=REC_FIT_EPOCHS,
               batch_end_callback=[callback.Speedometer(REC_BATCH, 20),
                                   sync.mark], epoch_end_callback=ce)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    staged = staging.check("fit")
    steps = REC_FIT_EPOCHS * batches
    rows["fit"] = _loop_report(
        f"fit over the records ({REC_FIT_EPOCHS} epochs of {batches} "
        f"batches, threads={cores})", wall, steps * REC_BATCH, steps, busy,
        pipe.waits, sync, smi, f", cross-entropy by epoch "
        f"{[round(v, 4) for v in ce.values]}, {staged} staged batches "
        f"checked", epoch=batches, speedometer=20)
    rows["fit"]["ce_by_epoch"] = ce.values
    if len(sync.marks) != steps or not ce.values[-1] < ce.values[0]:
        raise AssertionError(f"fit ran {len(sync.marks)} of {steps} "
                             f"batches, cross-entropy {ce.values}")
    # step_multi(8) over step_multi_feeds, 1 epoch of threads, then 1 of
    # decode processes
    from mxnet_tpu_torch import image

    feeders = {
        "step_multi": (f"threads={cores}", lambda: _record_iter(
            recs["train"], cores)),
        "step_multi_mp": (f"MultiProcessImageRecordIter workers="
                          f"{REC_MP_WORKERS}",
                          lambda: image.MultiProcessImageRecordIter(
                              recs["train"], REC_SHAPE, REC_BATCH,
                              num_workers=REC_MP_WORKERS,
                              preprocess_threads=1, shuffle=True,
                              rand_crop=True, rand_mirror=True,
                              stall_timeout=300))}
    for tag, (what, make) in feeders.items():
        base = make()
        pipe = _Timed(_stacked(base))
        ces = []
        try:
            with _StagingCheck() as staging, _ConsumerSyncs() as sync:
                # the first call's batches (the pipeline's start: worker
                # processes import and load their shards) are not timed
                for i, feed in enumerate(io.step_multi_feeds(pipe, REC_K)):
                    outs = tr.step_multi(**feed)
                    ces.append(_cross_entropy(outs[0],
                                              feed["softmax_label"]))
                    sync.mark(None)
                    if i == 0:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        del pipe.waits[:]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            if hasattr(base, "close"):
                base.close()
        staged = staging.check(tag)
        steps = batches - REC_K
        # the trainer's epochs 3 and 4 over the records: each one's mean
        # cross-entropy against fit's two (one call is too noisy)
        epoch_ce = torch.stack(ces).mean().item()
        rows[tag] = _loop_report(
            f"step_multi({REC_K}) over step_multi_feeds (1 epoch, {what}, "
            f"the last {steps} batches timed)", wall, steps * REC_BATCH,
            steps, busy, pipe.waits[:-1], sync, smi,
            f", the epoch's cross-entropy {epoch_ce:.4f} after fit's "
            f"{[round(v, 4) for v in ce.values]}, {staged} staged batches "
            f"checked")
        rows[tag]["ce_epoch"] = epoch_ce
        if not epoch_ce < ce.values[0]:
            raise AssertionError(f"{tag} over records: cross-entropy "
                                 f"{epoch_ce} after fit's {ce.values}")
    for tag in ("fit", "step_multi", "step_multi_mp"):
        rows[tag]["vs_resident"] = (rows[tag]["img_s"]
                                    / rows["resident"]["img_s"])
    line = {"metric": "train_records_imgs_per_sec", "batch": REC_BATCH,
            "dtype": "bfloat16", "threads": cores, "routes": rows,
            "device_kind": torch.cuda.get_device_name(0), "card": smi}
    log("[train_records] " + json.dumps(line))
    del tr
    torch.cuda.empty_cache()
    return line


def phase_module_records(smi, recs):
    """train_imagenet.py --fused 0 and score.py at full width: Module.fit
    as common/fit.py wires it (kvstore "device" on one card, SGD with
    momentum, Xavier, a Speedometer) over the records in fp32 for one
    epoch; a second short fit with Monitor(20, ".*weight"); then
    score.py's forward-only sweep over the val records with center
    crops, its epilogue launches each held against the plain version."""
    import logging

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import callback, metric, models

    cores = os.cpu_count() or 1
    mx.random.seed(0)
    mod = mx.mod.Module(models.get_symbol("resnet-50", num_classes=1000))
    init = mx.init.Xavier(rnd_type="gaussian", factor_type="in", magnitude=2)
    pipe = _Timed(_stacked(_record_iter(recs["train"], cores)))
    acc = metric.Accuracy()
    trace = _BatchCE()
    batches = REC_TRAIN // REC_BATCH
    with _ConsumerSyncs() as sync:
        t0 = time.perf_counter()
        mod.fit(pipe, num_epoch=1, kvstore="device", optimizer="sgd",
                optimizer_params=dict(REC_MODULE_OPT), initializer=init,
                eval_metric=acc,
                batch_end_callback=[callback.Speedometer(REC_BATCH, 20),
                                    sync.mark, trace])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_batch, logged = _per_batch(sync.marks, speedometer=20)
    first, last = trace.first_last()
    row = {"img_s": batches * REC_BATCH / wall,
           "step_ms": wall / batches * 1e3,
           "wait_ms_per_batch": sum(pipe.waits) / len(pipe.waits),
           "syncs_per_batch": sum(per_batch) / len(per_batch),
           "ce_first_last": [first, last]}
    log(f"[module_records] Module.fit fp32 over the records (1 epoch of "
        f"{batches} batches, threads={cores}, kvstore device): "
        f"{row['img_s']:.1f} img/s, {row['step_ms']:.3f} ms a batch, "
        f"waiting on the iterator {row['wait_ms_per_batch']:.3f} ms a "
        f"batch, host syncs a batch {row['syncs_per_batch']:.1f} (the "
        f"Speedometer's reads {sorted(set(logged))} on each of its "
        f"{len(logged)} log batches), train "
        f"accuracy {acc.get()[1]:.4f}, cross-entropy of the first and last "
        f"20 batches {first:.4f} -> {last:.4f}; {smi}")
    if any(per_batch) or len(sync.marks) != batches or not last < first:
        raise AssertionError(f"Module.fit syncs {per_batch}, "
                             f"cross-entropy {first} -> {last}")
    # the monitor: a row for every weight each 20th batch, reads only then
    weights = [n for n in mod.symbol.list_arguments() if n.endswith("weight")]
    mon = mx.Monitor(REC_MONITOR_EVERY, pattern=".*weight")
    rows = []

    class _Rows(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("Batch:"):
                rows.append(record.getMessage())

    handler = _Rows()
    root = logging.getLogger()
    root.addHandler(handler)
    level = root.level
    root.setLevel(logging.INFO)
    pipe = _stacked(_record_iter(recs["train"], cores))
    try:
        with _ConsumerSyncs() as sync:
            mod.fit(_Limited(pipe, REC_MONITOR_BATCHES), num_epoch=1,
                    kvstore="device", optimizer="sgd",
                    optimizer_params=dict(REC_MODULE_OPT), monitor=mon,
                    batch_end_callback=sync.mark)
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    per_batch = [b - a for a, b in zip([0] + sync.marks, sync.marks)]
    windows = [i for i, c in enumerate(per_batch) if c]
    want = list(range(0, REC_MONITOR_BATCHES, REC_MONITOR_EVERY))
    log(f"[module_records-monitor] Monitor({REC_MONITOR_EVERY}, "
        f"'.*weight') over {REC_MONITOR_BATCHES} batches: {len(rows)} rows "
        f"({len(weights)} weights x {len(want)} windows), host syncs by "
        f"batch {per_batch[:3]}..., at batches {windows}; e.g. "
        f"{rows[0].strip() if rows else None}; {smi}")
    if windows != want or len(rows) != len(weights) * len(want):
        raise AssertionError(f"monitor: rows {len(rows)}, syncs at "
                             f"{windows}")
    score = _score_records(mod, recs["val"], smi)
    del mod
    torch.cuda.empty_cache()
    return {"fit": row, "monitor_rows": len(rows), "score": score}


def _cross_entropy(probs, labels):
    """The mean cross-entropy (a tensor on the card, not read) of softmax
    outputs ``probs`` (``(..., B, classes)``) against ``labels`` (an
    NDArray, tensor, or a tuple of per-step ones)."""
    if isinstance(labels, (list, tuple)):
        labels = torch.stack([getattr(x, "tensor", x) for x in labels])
    labels = getattr(labels, "tensor", labels).long()
    p = probs.float().gather(-1, labels.unsqueeze(-1))
    return -p.clamp_min(1e-30).log().mean()


class _EpochCE:
    """A fused cross-entropy metric for ``fit`` and, as its epoch-end
    callback, the metric's value at each epoch's end (the boundary,
    where the loop reads anyway)."""

    def __init__(self):
        from mxnet_tpu_torch import metric

        self.metric = metric.CrossEntropy()
        self.values = []

    def __call__(self, epoch, symbol, arg, aux):
        self.values.append(self.metric.get()[1])


class _BatchCE:
    """A Module batch-end callback keeping each batch's cross-entropy on
    the card (from the module's outputs and the batch's labels)."""

    def __init__(self):
        self.ces = []

    def __call__(self, param):
        mod, batch = param.locals["self"], param.locals["data_batch"]
        self.ces.append(_cross_entropy(mod.get_outputs()[0].tensor,
                                       batch.label[0]))

    def first_last(self, n=20):
        ces = torch.stack(self.ces).float()
        n = max(1, min(n, len(self.ces) // 2))
        return ces[:n].mean().item(), ces[-n:].mean().item()


class _Limited:
    """The first ``n`` batches of ``it``, as an iterator of its own."""

    def __init__(self, it, n):
        self.it, self.n, self.k = it, n, 0
        self.batch_size = it.batch_size
        self.provide_data, self.provide_label = (it.provide_data,
                                                 it.provide_label)

    def reset(self):
        self.k = 0
        self.it.reset()

    def __iter__(self):
        return self

    def __next__(self):
        if self.k >= self.n:
            raise StopIteration
        self.k += 1
        return self.it.next()


def _score_records(mod, val, smi):
    """score.py's route: the trained parameters into a forward-only
    Module over the val records with center crops and no mirror; a
    timed sweep (accuracy, top-5, images/s with the pipeline, as
    score.py times it), then a second sweep whose every epilogue launch
    is held against the plain version (4 a forward)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import image, metric
    from mxnet_tpu_torch.ops import residual_epilogue as tre

    arg, aux = mod.get_params()

    def sweep(check=None):
        it = _stacked(image.ImageRecordIter(
            val, REC_SHAPE, REC_BATCH, preprocess_threads=os.cpu_count()))
        sm = mx.mod.Module(mod.symbol, label_names=["softmax_label"])
        sm.bind(for_training=False, data_shapes=it.provide_data,
                label_shapes=it.provide_label)
        sm.set_params(arg, aux)
        metrics = [metric.Accuracy(), metric.TopKAccuracy(top_k=5)]
        n0, forwards, num, checked = tre.launch_count(), 0, 0, 0
        t0 = time.perf_counter()
        for batch in it:
            sm.forward(batch, is_train=False)
            for m in metrics:
                sm.update_metric(m, batch.label)
            num += batch.data[0].shape[0]
            forwards += 1
            if check is not None:
                checked += check.check("score.py route")
        res = [m.get() for m in metrics]
        wall = time.perf_counter() - t0
        return (res, num / wall, forwards, tre.launch_count() - n0,
                checked)

    res, img_s, forwards, launched, _ = sweep()
    with _EpilogueRecorder() as rec:
        res2, _, forwards2, launched2, checked = sweep(rec)
    log(f"[module_records-score] score.py over {REC_VAL} val records "
        f"(center crop, no mirror): {res}, {img_s:.1f} img/s, {launched} "
        f"epilogue launches in {forwards} forwards; a second sweep's "
        f"{launched2} launches each within its bound of the plain version "
        f"({checked} checked, same metrics: {res2 == res}); {smi}")
    if (launched != 4 * forwards or launched2 != 4 * forwards2
            or checked != launched2 or res2 != res):
        raise AssertionError(f"score.py route: {launched}/{launched2} "
                             f"epilogue launches in {forwards} forwards, "
                             f"{checked} checked, {res} vs {res2}")
    return {"metrics": res, "img_s": img_s, "forwards": forwards,
            "epilogue_launches": launched + launched2}


def _mnist_files(workdir):
    """Seeded idx files of MNIST's shape: class templates plus noise,
    60,000 train and 10,000 test images of 28 x 28."""
    import struct

    rs = np.random.RandomState(11)
    templates = rs.uniform(0, 255, (10, 28, 28))
    paths = {}
    for name, n in (("train", MNIST_TRAIN), ("t10k", MNIST_TEST)):
        labels = rs.randint(0, 10, n)
        images = np.clip(templates[labels] + rs.normal(0, 60, (n, 28, 28)),
                         0, 255).astype(np.uint8)
        for kind, arr in (("images-idx3-ubyte", images),
                          ("labels-idx1-ubyte", labels.astype(np.uint8))):
            path = os.path.join(workdir, f"{name}-{kind}")
            with open(path, "wb") as f:
                f.write(struct.pack(">I", 0x0800 | arr.ndim))
                f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
                f.write(arr.tobytes())
            paths[f"{name}-{kind}"] = path
    return paths


def phase_sequential(smi, workdir):
    """examples/module/sequential_module.py's chain (32 -> 64 -> 5 at
    batch 50) through SequentialModule.fit on the card, and
    train_mnist.py's MLP (128-64-10) through Module.fit over MNISTIter
    on seeded idx files of MNIST's shape."""
    import mxnet_tpu_torch as mx

    rs = np.random.RandomState(0)
    x = rs.uniform(0, 1, (SEQ_SAMPLES, 32)).astype(np.float32)
    w = rs.normal(size=(32, 5)).astype(np.float32)
    y = (x @ w).argmax(axis=1).astype(np.float32)
    mx.random.seed(0)
    np.random.seed(0)
    train = mx.io.NDArrayIter(x, y, SEQ_BATCH, shuffle=True)
    data = mx.sym.Variable("data")
    trunk = mx.sym.Activation(
        mx.sym.FullyConnected(data, name="fc1", num_hidden=64),
        name="relu1", act_type="relu")
    feat = mx.sym.Variable("fc1_output")
    head = mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(feat, name="fc2", num_hidden=5),
        name="softmax")
    seq = mx.mod.SequentialModule()
    seq.add(mx.mod.Module(trunk, label_names=[]))
    seq.add(mx.mod.Module(head, data_names=["fc1_output"]),
            take_labels=True, auto_wiring=True)
    with _ConsumerSyncs() as sync:
        t0 = time.perf_counter()
        seq.fit(train, optimizer="sgd", num_epoch=SEQ_EPOCHS,
                optimizer_params={"learning_rate": 0.2},
                initializer=mx.init.Xavier(),
                batch_end_callback=[mx.callback.Speedometer(SEQ_BATCH, 20),
                                    sync.mark])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_batch, logged = _per_batch(sync.marks, SEQ_SAMPLES // SEQ_BATCH, 20)
    acc = dict(seq.score(train, mx.metric.Accuracy()))["accuracy"]
    seq_row = {"img_s": SEQ_EPOCHS * SEQ_SAMPLES / wall, "accuracy": acc,
               "syncs_per_batch": sum(per_batch) / len(per_batch)}
    log(f"[sequential] sequential_module.py's chain 32 -> 64 -> 5, batch "
        f"{SEQ_BATCH}, {SEQ_EPOCHS} epochs: {seq_row['img_s']:.1f} "
        f"samples/s, train accuracy {acc:.4f}, host syncs a batch "
        f"{seq_row['syncs_per_batch']:.1f} (the Speedometer's reads "
        f"{sorted(set(logged))} on each of its {len(logged)} log batches)"
        f"; {smi}")
    if any(per_batch) or not acc > 0.5:
        raise AssertionError(f"SequentialModule: acc {acc}, syncs "
                             f"{per_batch}")
    files = _mnist_files(workdir)
    train = mx.io.MNISTIter(image=files["train-images-idx3-ubyte"],
                            label=files["train-labels-idx1-ubyte"],
                            batch_size=MNIST_BATCH, shuffle=True)
    val = mx.io.MNISTIter(image=files["t10k-images-idx3-ubyte"],
                          label=files["t10k-labels-idx1-ubyte"],
                          batch_size=MNIST_BATCH, shuffle=False)
    mod = mx.mod.Module(mx.models.mlp.get_symbol(num_classes=10))
    batches = MNIST_TRAIN // MNIST_BATCH
    with _ConsumerSyncs() as sync:
        t0 = time.perf_counter()
        mod.fit(train, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
                initializer=mx.init.Xavier(),
                batch_end_callback=[mx.callback.Speedometer(MNIST_BATCH,
                                                            200), sync.mark])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_batch, logged = _per_batch(sync.marks, speedometer=200)
    acc = dict(mod.score(val, mx.metric.Accuracy()))["accuracy"]
    mnist_row = {"img_s": batches * MNIST_BATCH / wall, "val_accuracy": acc,
                 "syncs_per_batch": sum(per_batch) / len(per_batch)}
    log(f"[sequential-mnist] train_mnist.py's MLP 128-64-10 over MNISTIter "
        f"({MNIST_TRAIN} x 28 x 28, batch {MNIST_BATCH}, 1 epoch): "
        f"{mnist_row['img_s']:.1f} img/s, val accuracy {acc:.4f} on "
        f"{MNIST_TEST}, host syncs a batch "
        f"{mnist_row['syncs_per_batch']:.1f} (the Speedometer's reads "
        f"{sorted(set(logged))} on each of its {len(logged)} log batches)"
        f"; {smi}")
    if any(per_batch) or not acc > 0.5:
        raise AssertionError(f"MNIST MLP: acc {acc}, syncs {per_batch}")
    return {"sequential": seq_row, "mnist": mnist_row}


# ---------------------------------------------------------- phases 19-23
# examples/recommenders/sparse_mf.py's sizes (USERS, ITEMS, RANK and its
# argparse defaults, but 2 epochs)
MF_USERS, MF_ITEMS, MF_RANK = 20000, 8000, 8
MF_BATCH, MF_SAMPLES, MF_EPOCHS, MF_LR = 256, 40000, 2, 0.05
# bench.py:1623-1689 (_sparse_micro): Adam lr 0.05, rescale 1/lookups,
# 8 distinct steps, 3 warm-up and 20 timed pushes; and a 10 M-row catalog
SPARSE_SIZES = ((300000, 64, 4096), (10_000_000, 64, 4096))
SPARSE_STEPS, SPARSE_WARMUP = 20, 3
SPARSE_TOL = 1e-6                # the card's row update vs the CPU's
SURV_STEPS, SURV_EVERY = 40, 10  # bench.py:577-642 (_survival_micro)
KILL_SAMPLES, KILL_BATCH, KILL_EPOCHS, KILL_EVERY = 4096, 64, 2, 10
REMAT_K = 8
REMAT_DROPOUT = 0.1


def _mf_symbol():
    """``sparse_mf.build()`` in the port: both tables ``grad_stype=
    "row_sparse"``."""
    from mxnet_tpu_torch import symbol as sym

    uw = sym.Variable("user_embed_weight", grad_stype="row_sparse")
    iw = sym.Variable("item_embed_weight", grad_stype="row_sparse")
    u = sym.Embedding(sym.Variable("user"), weight=uw, input_dim=MF_USERS,
                      output_dim=MF_RANK, name="user_embed")
    v = sym.Embedding(sym.Variable("item"), weight=iw, input_dim=MF_ITEMS,
                      output_dim=MF_RANK, name="item_embed")
    return sym.LinearRegressionOutput(sym.sum(u * v, axis=1),
                                      sym.Variable("score_label"),
                                      name="score")


def _mf_synth(rs, n):
    """``sparse_mf.synth``: low-rank ratings over a popularity-skewed
    catalog."""
    gu = rs.randn(MF_USERS, MF_RANK).astype(np.float32) * 0.7
    gi = rs.randn(MF_ITEMS, MF_RANK).astype(np.float32) * 0.7
    users = rs.randint(0, MF_USERS, n)
    items = np.minimum((rs.pareto(1.2, n) * MF_ITEMS / 60).astype(np.int64),
                       MF_ITEMS - 1)
    ratings = (gu[users] * gi[items]).sum(1) \
        + rs.randn(n).astype(np.float32) * 0.1
    return (users.astype(np.float32), items.astype(np.float32),
            ratings.astype(np.float32))


def _mf_route(tag, smi, data):
    """``sparse_mf.py``'s loop through ``Module.fit`` on the card: rmse
    by epoch, the holders' storage type, the touched rows, host syncs a
    batch (0 within each epoch), samples/s."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io, metric

    users, items, ratings = data
    np.random.seed(0)  # the iterator's shuffle
    mod = mx.mod.Module(_mf_symbol(), data_names=("user", "item"),
                        label_names=("score_label",))
    it = io.NDArrayIter({"user": users, "item": items},
                        {"score_label": ratings}, batch_size=MF_BATCH,
                        shuffle=True)
    rmse = metric.create("rmse")
    by_epoch, stamps = [], []

    def epoch_end(epoch, sym, arg, aux):
        by_epoch.append(rmse.get_global()[1])
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _SyncCounter() as sync:
        mod.fit(it, num_epoch=MF_EPOCHS, optimizer="adam",
                optimizer_params={"learning_rate": MF_LR},
                initializer=mx.init.Normal(0.1), eval_metric=rmse,
                batch_end_callback=sync.mark, epoch_end_callback=epoch_end)
    wall = time.perf_counter() - t0
    nb = len(sync.marks) // MF_EPOCHS
    per_batch = [b - a for e in range(MF_EPOCHS)
                 for a, b in zip(sync.marks[e * nb:(e + 1) * nb],
                                 sync.marks[e * nb + 1:(e + 1) * nb])]
    ex = mod._exec_group.execs[0]
    holders = {w: ex.grad_dict[w] for w in ("user_embed_weight",
                                            "item_embed_weight")}
    stypes = {w: getattr(g, "stype", "default") for w, g in holders.items()}
    slots = {w: int(g.indices.shape[0]) for w, g in holders.items()}
    touched = {w: int(torch.unique(g.indices.tensor).numel())
               for w, g in holders.items()}
    epoch2_s = MF_SAMPLES / (stamps[1] - stamps[0])
    log(f"[sparse_mf] {tag}: {MF_USERS} users x {MF_ITEMS} items, rank "
        f"{MF_RANK}, batch {MF_BATCH}, Adam lr {MF_LR}, {MF_SAMPLES} samples "
        f"x {MF_EPOCHS} epochs: train rmse by epoch "
        f"{' '.join(f'{r:.4f}' for r in by_epoch)}; gradient holders "
        f"{stypes}, {slots} row slots a batch ({touched} distinct rows in the "
        f"last), of {MF_USERS} / {MF_ITEMS} rows; host syncs a batch within "
        f"the epochs: max {max(per_batch)} over {len(per_batch)} batch "
        f"pairs (before the first batch's end {sync.marks[0]}); "
        f"{MF_EPOCHS * MF_SAMPLES / wall:.1f} samples/s over the fit, "
        f"{epoch2_s:.1f} in epoch 2; {smi}")
    if set(stypes.values()) != {"row_sparse"}:
        raise AssertionError(f"sparse_mf {tag}: dense gradients {stypes}")
    if any(per_batch):
        raise AssertionError(f"sparse_mf {tag}: host syncs a batch "
                             f"{per_batch}")
    if not (len(by_epoch) == MF_EPOCHS and by_epoch[-1] < by_epoch[0]
            and all(math.isfinite(r) for r in by_epoch)):
        raise AssertionError(f"sparse_mf {tag}: rmse {by_epoch}")
    return {"rmse": by_epoch, "samples_s": MF_EPOCHS * MF_SAMPLES / wall,
            "epoch2_samples_s": epoch2_s, "syncs_per_batch": max(per_batch),
            "row_slots": slots, "touched_rows": touched}


def phase_sparse_mf(smi):
    """(a1) ``examples/recommenders/sparse_mf.py`` on the card: fp32, then
    ``MXTPU_AMP=bf16`` with dynamic loss scaling."""
    data = _mf_synth(np.random.RandomState(0), MF_SAMPLES)
    res = {"fp32": _mf_route("fp32", smi, data)}
    from mxnet_tpu_torch import amp

    amp.reset_scaler()
    res["amp"] = _with_env(MODULE_AMP_ENV,
                           lambda: _mf_route("amp bf16", smi, data))
    amp.reset_scaler()
    log(f"[sparse_mf] {json.dumps(res)}")
    return res


def _sparse_bounds(rows, dim, lookups, uniq):
    """The least time of one Adam step: the dense side sweeps the table
    and its two slots, read and written; the sparse side reads the
    pushed rows and ids and reads and writes the touched rows of the
    table and slots.  Both over the memory rate."""
    dense = 3 * 2 * rows * dim * 4
    sparse = lookups * (dim * 4 + 4) + 3 * 2 * uniq * dim * 4
    return dense / PEAK_BYTES_S * 1e3, sparse / PEAK_BYTES_S * 1e3


def phase_sparse_update(smi):
    """(a2) ``_sparse_micro``'s kvstore step on the card, sparse and
    dense, at its own table and a 10 M-row one: µs a step, the speedup,
    the touched fraction, touched rows/s, each side's bound; the sparse
    run queues no host sync (``set_sync_debug_mode("error")``) and, at
    the small table, equals the same pushes on the CPU."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import sparse
    from mxnet_tpu_torch.ndarray import NDArray

    out = []
    for rows, dim, lookups in SPARSE_SIZES:
        g = torch.Generator(device="cuda").manual_seed(11)
        table = torch.rand((rows, dim), generator=g, device="cuda") * 2 - 1
        distinct = 8 if rows * dim * 4 * 8 < 8e9 else 2
        idx = [torch.randint(0, rows, (lookups,), generator=g,
                             device="cuda", dtype=torch.int32)
               for _ in range(distinct)]
        vals = [torch.rand((lookups, dim), generator=g, device="cuda") * 2 - 1
                for _ in range(distinct)]
        uniq = float(np.mean([torch.unique(i).numel() for i in idx]))

        def store(device, sparse_grads):
            kv = mx.kv.create("local")
            kv.set_optimizer(mx.optimizer.create(
                "adam", learning_rate=0.05, rescale_grad=1.0 / lookups))
            t = NDArray(table.to(device))
            kv.init(0, sparse.full_row_sparse(t) if sparse_grads else t)
            return kv

        def run(sparse_grads):
            kv = store("cuda", sparse_grads)
            grads = []
            for i, v in zip(idx, vals):
                rg = sparse.RowSparseNDArray(i, v, (rows, dim))
                grads.append([rg] if sparse_grads else [rg.todense()])
            for w in range(SPARSE_WARMUP):
                kv.push([0], grads[w % distinct])
            torch.cuda.synchronize()
            if sparse_grads:
                torch.cuda.set_sync_debug_mode("error")
            try:
                t0 = time.perf_counter()
                for s in range(SPARSE_STEPS):
                    kv.push([0], grads[s % distinct])
                torch.cuda.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            dt = (time.perf_counter() - t0) / SPARSE_STEPS
            return dt, kv

        dense_dt, kv = run(False)
        del kv
        torch.cuda.empty_cache()
        sparse_dt, kv = run(True)
        err = None
        if rows * dim <= 5e7:
            # the same pushes on the CPU: the row update's arithmetic
            ref = store("cpu", True)
            for s in range(SPARSE_WARMUP + SPARSE_STEPS):
                k = (s if s < SPARSE_WARMUP else s - SPARSE_WARMUP) % distinct
                ref.push([0], [sparse.RowSparseNDArray(
                    idx[k].cpu(), vals[k].cpu(), (rows, dim))])
            got = kv._store[0].tensor.cpu()
            want = ref._store[0].tensor
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, rtol=SPARSE_TOL,
                                  atol=SPARSE_TOL):
                raise AssertionError(f"sparse update {rows} rows: card vs "
                                     f"CPU max err {err}")
            del ref
        del kv, table, idx, vals
        torch.cuda.empty_cache()
        b_dense, b_sparse = _sparse_bounds(rows, dim, lookups, uniq)
        rec = {"rows": rows, "dim": dim, "lookups": lookups,
               "us_sparse": sparse_dt * 1e6, "us_dense": dense_dt * 1e6,
               "speedup": dense_dt / sparse_dt,
               "touched_fraction": uniq / rows,
               "touched_rows_s": uniq / sparse_dt,
               "bound_us_dense": b_dense * 1e3,
               "bound_us_sparse": b_sparse * 1e3,
               "card_vs_cpu_max_err": err}
        out.append(rec)
        log(f"[sparse_update] {rows} x {dim} table, {lookups} lookups "
            f"({uniq:.1f} distinct rows, {uniq / rows:.3g} of the table), "
            f"Adam: sparse {sparse_dt * 1e6:.1f} µs a step (bound "
            f"{b_sparse * 1e3:.2f} µs), dense {dense_dt * 1e6:.1f} µs "
            f"(bound {b_dense * 1e3:.1f} µs), speedup "
            f"{dense_dt / sparse_dt:.1f}x; {uniq / sparse_dt:.4g} touched "
            f"rows/s; sparse pushes with no host sync; card vs CPU max err "
            f"{err} (tol {SPARSE_TOL}); {smi}")
    log(f"[sparse_update] {json.dumps(out)}")
    return out


def _survival_micro(tr, batch, tag, smi):
    """``_survival_micro``'s keys for trainer ``tr`` on one staged batch:
    step µs plain and with a background ``save_state`` every
    ``SURV_EVERY`` steps, the capture's cost a step, a synchronous
    write, a restore into a fresh trainer of the same graph, the state
    bytes.  Returns the keys and the directory's checkpoint."""
    for _ in range(3):
        tr.step(**batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SURV_STEPS):
        tr.step(**batch)
    torch.cuda.synchronize()
    plain_us = (time.perf_counter() - t0) / SURV_STEPS * 1e6
    from mxnet_tpu_torch import checkpoint as ck

    d = tempfile.mkdtemp(prefix="chip_smoke_surv_")
    writes, dispatch = [], 0.0
    t0 = time.perf_counter()
    for i in range(SURV_STEPS):
        tr.step(**batch)
        if i % SURV_EVERY == 0:
            td = time.perf_counter()
            writes.append(tr.save_state(d, background=True))
            dispatch += time.perf_counter() - td
    torch.cuda.synchronize()
    armed_us = (time.perf_counter() - t0) / SURV_STEPS * 1e6
    for w in writes:
        w.wait()
    # the same cadence with a writer of the same bytes from host memory
    # (no CUDA in the writer): what the writer thread alone costs the
    # training thread
    host = {k: v.detach().cpu().numpy()
            for k, v in tr._checkpoint_arrays().items()}
    hd = tempfile.mkdtemp(prefix="chip_smoke_surv_host_")
    writes = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(SURV_STEPS):
        tr.step(**batch)
        if i % SURV_EVERY == 0:
            writes.append(ck.save(hd, i, host, background=True))
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / SURV_STEPS * 1e6
    for w in writes:
        w.wait()
    shutil.rmtree(hd, ignore_errors=True)
    del host
    final = os.path.join(d, "final")
    t0 = time.perf_counter()
    tr.save_state(final, background=False)
    write_ms = (time.perf_counter() - t0) * 1e3
    nbytes = sum(v.numel() * v.element_size()
                 for v in tr._checkpoint_arrays().values())
    res = {"ckpt_step_us_plain": plain_us, "ckpt_step_us_armed": armed_us,
           "ckpt_capture_us_per_step": armed_us - plain_us,
           "ckpt_write_ms": write_ms, "ckpt_state_bytes": nbytes,
           "snapshots": len(writes),
           "save_state_call_ms": dispatch / len(writes) * 1e3,
           "host_writer_us_per_step": host_us - plain_us}
    log(f"[survival] {tag}: {json.dumps(res)}; {smi}")
    return res, d, final


def phase_survival(smi):
    """(b1) ResNet-50 bf16 batch 32 (slice 5's ``FusedTrainer``) through
    the survival layer: ``_survival_micro``'s keys; a restore into a
    fresh trainer whose next step equals the saving trainer's (with
    deterministic algorithms); ``predict.create`` from the resumed
    trainer's checkpoint against the Predictor of the saving trainer's
    parameters, every epilogue launch held against the plain version;
    and the micro-bench's own FC net (512 -> 256, batch 64)."""
    from mxnet_tpu_torch import predict, sym
    from mxnet_tpu_torch.trainer import FusedTrainer

    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.rand((RESNET_BATCH, 3, 224, 224), generator=g, device="cuda")
    y = torch.randint(0, 1000, (RESNET_BATCH,), generator=g,
                      device="cuda").float()
    batch = {"data": x, "softmax_label": y}
    tr = _resnet_trainer("bfloat16")
    res, d, final = _survival_micro(tr, batch, "resnet-50 bf16 b32", smi)
    try:
        tr2 = _resnet_trainer("bfloat16")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meta = tr2.restore_state(final)
        torch.cuda.synchronize()
        res["ckpt_resume_ms"] = (time.perf_counter() - t0) * 1e3
        # predict.create from the resumed state, against the Predictor of
        # the saving trainer's in-memory parameters
        prefix = os.path.join(d, "resumed")
        tr2.save_checkpoint(prefix, 0)
        shapes = {"data": (RESNET_BATCH, 3, 224, 224)}
        xn = x.cpu().numpy()
        arg, aux = tr.get_params()
        ref = _predictor(tr.symbol, arg, aux)
        ref.forward(data=xn)
        want = ref.get_output(0)
        del ref
        _kernel_launches(reset=True)
        with _EpilogueRecorder() as rec:
            p = predict.create(prefix, 0, shapes)
            p.forward(data=xn)
            got = p.get_output(0)
            checked = rec.check("survival predict.create")
        launches = _kernel_launches()
        del p
        err = float(np.abs(got - want).max())
        if (launches["residual_epilogue"] != 4 or checked != 4
                or any(v for k, v in launches.items()
                       if k != "residual_epilogue")):
            raise AssertionError(f"survival predict.create launched "
                                 f"{launches}, {checked} checked; want 4 "
                                 "epilogue launches and no other")
        if got.shape != (RESNET_BATCH, 1000) or err != 0.0:
            raise AssertionError(f"survival: resumed Predictor vs saving "
                                 f"trainer's: {got.shape}, max err {err}")
        # the next step from the restored state equals the saving
        # trainer's next step
        torch.use_deterministic_algorithms(True)
        try:
            o2 = tr2.step(**batch)[0]
            o1 = tr.step(**batch)[0]
            torch.cuda.synchronize()
            det = "deterministic algorithms"
        except RuntimeError as exc:
            # an op with no deterministic CUDA implementation: name it
            # and compare with the default algorithms instead
            det = f"default algorithms ({str(exc).splitlines()[0][:160]})"
            torch.use_deterministic_algorithms(False)
            for t in (tr, tr2):
                t.restore_state(final)
            o2 = tr2.step(**batch)[0]
            o1 = tr.step(**batch)[0]
        finally:
            torch.use_deterministic_algorithms(False)
        step_err = max(float((tr.params[k] - tr2.params[k]).abs().max())
                       for k in tr.params)
        out_err = float((o1.float() - o2.float()).abs().max())
        log(f"[survival] restore into a fresh trainer: step {meta['step']}, "
            f"{res['ckpt_resume_ms']:.1f} ms; the next step under {det}: "
            f"max |param diff| {step_err:.3g}, max |output diff| "
            f"{out_err:.3g}; predict.create from the resumed trainer's "
            f"checkpoint vs the saving trainer's Predictor: max |prob diff| "
            f"{err} (identical), {checked} epilogue launches each within its "
            f"bound of the plain version; {smi}")
        if det == "deterministic algorithms" and (step_err or out_err):
            raise AssertionError(f"survival: resumed step differs by "
                                 f"{step_err} / {out_err}")
        res.update(resume_step_err=step_err, resume_out_err=out_err,
                   determinism=det, epilogue_launches=launches[
                       "residual_epilogue"], predict_err=err)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    del tr, tr2
    torch.cuda.empty_cache()
    # the micro-bench's own net, like for like
    net = sym.SoftmaxOutput(sym.FullyConnected(
        sym.Variable("data"), num_hidden=256, name="surv_fc"),
        name="softmax")
    rs = np.random.RandomState(11)
    fc = FusedTrainer(net, optimizer="adam", optimizer_params={
        "lr": 0.05, "rescale_grad": 1.0 / 64}).init(data=(64, 512))
    fb = {"data": torch.from_numpy(rs.uniform(-1, 1, (64, 512))
                                   .astype(np.float32)).cuda(),
          "softmax_label": torch.from_numpy(
              rs.randint(0, 256, 64).astype(np.float32)).cuda()}
    fres, fd, ffinal = _survival_micro(fc, fb, "fc 512->256 b64", smi)
    t0 = time.perf_counter()
    fc.restore_state(ffinal)
    torch.cuda.synchronize()
    fres["ckpt_resume_ms"] = (time.perf_counter() - t0) * 1e3
    shutil.rmtree(fd, ignore_errors=True)
    res["fc_net"] = fres
    log(f"[survival] {json.dumps(res)}")
    return res


_KILL_CHILD = r'''
import os, signal, sys, json, time
import numpy as np
import torch
torch.use_deterministic_algorithms(True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
sys.path.insert(0, os.environ["CHIP_SMOKE_REPO"])
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import checkpoint as ck

mode, out = sys.argv[1], sys.argv[2]
ckdir = os.environ["MXTPU_CKPT_DIR"]
rs = np.random.RandomState(0)
n, b = int(sys.argv[3]), int(sys.argv[4])
X = rs.uniform(0, 1, (n, 784)).astype(np.float32)
Y = rs.randint(0, 10, n).astype(np.float32)
it = mx.io.NDArrayIter(X, Y, batch_size=b, shuffle=False)
mx.random.seed(0)
mod = mx.mod.Module(mx.models.get_symbol("mlp", num_classes=10))
term = []
signal.signal(signal.SIGTERM, lambda s, f: term.append(s))
cb = None
if mode == "victim":
    def cb(p):
        if (p.epoch, p.nbatch) == (1, 10):
            # killable once a checkpoint is published: poll for it
            while ck.latest(ckdir) is None:
                time.sleep(0.01)
            print("KILLME", flush=True)
            while True:
                time.sleep(1)
elif mode == "preempt":
    def cb(p):
        if (p.epoch, p.nbatch) == (0, 20):
            print("TERMME", flush=True)
            while not term:
                time.sleep(0.01)
try:
    mod.fit(it, num_epoch=int(sys.argv[5]), optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=mx.init.Xavier(), resume=(mode == "resume"),
            batch_end_callback=cb)
except ck.Preempted as e:
    print("PREEMPTED", e, flush=True)
    sys.exit(3)
arg, _ = mod.get_params()
np.savez(out, **{k: v.asnumpy() for k, v in arg.items()})
print("DONE", flush=True)
'''


def phase_kill_resume(smi):
    """(b2) ``train_mnist.py``'s MLP through ``Module.fit`` in child
    processes on the card with ``MXTPU_CKPT_DIR``/``MXTPU_CKPT_EVERY``
    set: an uninterrupted child, a child SIGKILLed once it says a
    checkpoint is published, a child resuming it, and a child given a
    SIGTERM; deterministic algorithms and ``CUBLAS_WORKSPACE_CONFIG``
    in all.  The resumed parameters must equal the uninterrupted ones to
    the bit; the SIGTERM leaves a boundary checkpoint and ``Preempted``.
    The parent waits on the children's markers, never on a sleep."""
    import signal as _signal

    from mxnet_tpu_torch import checkpoint as ck

    tmp = tempfile.mkdtemp(prefix="chip_smoke_kill_")
    script = os.path.join(tmp, "child.py")
    with open(script, "w") as f:
        f.write(_KILL_CHILD)
    repo = os.path.dirname(os.path.abspath(__file__))
    args = [str(KILL_SAMPLES), str(KILL_BATCH), str(KILL_EPOCHS)]

    def start(mode, ckdir, out):
        env = dict(os.environ, CHIP_SMOKE_REPO=repo, MXTPU_CKPT_DIR=ckdir,
                   MXTPU_CKPT_EVERY=str(KILL_EVERY),
                   CUBLAS_WORKSPACE_CONFIG=":4096:8")
        return subprocess.Popen(
            [sys.executable, script, mode, out] + args,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)

    def until(proc, marker, what):
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if marker in line:
                return "".join(lines)
        proc.wait(timeout=60)
        raise AssertionError(f"{what} child ended without {marker}: "
                             + "".join(lines)[-3000:])

    def finish(proc, what, rc=0):
        out, _ = proc.communicate(timeout=300)
        if proc.returncode != rc:
            raise AssertionError(f"{what} child exited {proc.returncode}: "
                                 f"{out[-3000:]}")
        return out

    t0 = time.perf_counter()
    try:
        d = {m: os.path.join(tmp, m) for m in ("straight", "victim",
                                               "preempt")}
        procs = {m: start(m, d[m], os.path.join(tmp, m + ".npz"))
                 for m in d}
        until(procs["victim"], "KILLME", "victim")
        procs["victim"].send_signal(_signal.SIGKILL)
        procs["victim"].wait(timeout=60)
        killed = procs["victim"].returncode
        published = ck.list_checkpoints(d["victim"])
        until(procs["preempt"], "TERMME", "preempt")
        procs["preempt"].send_signal(_signal.SIGTERM)
        pout = finish(procs["preempt"], "preempt", rc=3)
        finish(procs["straight"], "straight")
        resumed = start("resume", d["victim"], os.path.join(tmp,
                                                            "resume.npz"))
        rout = finish(resumed, "resume")
        straight = np.load(os.path.join(tmp, "straight.npz"))
        again = np.load(os.path.join(tmp, "resume.npz"))
        diffs = {k: float(np.abs(straight[k] - again[k]).max())
                 for k in straight.files}
        _, pman = ck.load(ck.latest(d["preempt"]))
        cursor = (pman["meta"]["epoch"], pman["meta"]["nbatch"])
        wall = time.perf_counter() - t0
        log(f"[kill_resume] train_mnist MLP, {KILL_SAMPLES} samples, batch "
            f"{KILL_BATCH}, {KILL_EPOCHS} epochs, a checkpoint every "
            f"{KILL_EVERY} steps: the victim was SIGKILLed (exit {killed}) "
            f"at epoch 1 batch 10 with {len(published)} complete "
            f"checkpoints (newest step {published[-1][0]}); the resumed "
            f"child's parameters vs the uninterrupted child's: max |diff| "
            f"{max(diffs.values())} over {len(diffs)} arrays (deterministic "
            f"algorithms); the SIGTERMed child saved its boundary checkpoint "
            f"at (epoch, batch) {cursor} and exited by Preempted "
            f"({pout.strip().splitlines()[-1][:120]}); {wall:.1f} s; {smi}")
        if killed != -_signal.SIGKILL or not published:
            raise AssertionError(f"kill_resume: victim exit {killed}, "
                                 f"{published}")
        if any(diffs.values()):
            raise AssertionError(f"kill_resume: resumed params differ "
                                 f"{diffs}; {rout[-2000:]}")
        if cursor != (0, 21):
            raise AssertionError(f"kill_resume: boundary checkpoint at "
                                 f"{cursor}, want (0, 21)")
        return {"killed_with_checkpoints": len(published),
                "max_diff": max(diffs.values()), "preempt_cursor": cursor,
                "wall_s": wall}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_remat(smi):
    """(c) ``transformer_lm(**MFU_HEADLINE_CONFIG)`` through
    ``FusedTrainer`` at bf16 (slice 2's step: Adam lr 1e-4, batch 8 x
    1024) with ``remat=False`` and ``remat=True``, eager and
    ``step_multi(8)``: peak memory, step ms, tokens/s, flash launches a
    step (the forward twice under remat); one step of each from the same
    weights agrees within the bf16 tolerance of ``phase_train``; with
    ``dropout=0.1`` the recomputed masks are the forward's (remat and
    plain agree from the same generator state, and a plain step from
    another state does not).  Returns the flash launches of the remat
    run and the numbers."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.convert import load_trainer_params
    from mxnet_tpu_torch.models import transformer as tr
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.trainer import FusedTrainer

    cfg = tr.MFU_HEADLINE_CONFIG
    B, T, V, L = TRAIN_BATCH, cfg["seq_len"], cfg["vocab_size"], \
        cfg["num_layers"]
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.integers(0, V, (B, T)).astype(np.float32))
    label = torch.from_numpy(rng.integers(0, V, (B, T)).astype(np.float32))

    def trainer(remat, dropout=0.0, params=None):
        t = FusedTrainer(tr.transformer_lm(dropout=dropout, **cfg),
                         optimizer="adam", optimizer_params={"lr": 1e-4},
                         dtype="bfloat16", remat=remat).init(
            data=(B, T), softmax_label=(B, T))
        if params is not None:
            load_trainer_params(t, params)
        return t

    def moments(t):
        return {k: st[0].clone() for k, st in t.opt_state.items()}

    def agree(o1, m1, o2, m2):
        errs = sorted((_rel_err(m1[k], m2[k]), k) for k in m1
                      if not k.endswith("_k_bias"))
        return _rel_err(o1, o2), errs[-1]

    def route(t, tag):
        """Timed eager steps, then ``step_multi(8)``: ms a step, peak
        allocated memory of each, flash launches a step."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            t.step(data=data, softmax_label=label)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
        launches = {k: v / TRAIN_STEPS for k, v in fa.launch_counts().items()}
        eager_peak = torch.cuda.max_memory_allocated()
        stacked = {"data": torch.stack([data] * REMAT_K),
                   "softmax_label": torch.stack([label] * REMAT_K)}
        # the capture's pool and the k stacked outputs (4 GiB) need
        # whole segments: hand the cached ones back first
        torch.cuda.empty_cache()
        t.step_multi(**stacked)  # capture
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs = t.step_multi(**stacked)[0]
        torch.cuda.synchronize()
        multi_ms = (time.perf_counter() - t0) / REMAT_K * 1e3
        multi_peak = torch.cuda.max_memory_allocated()
        if not bool(torch.isfinite(outs).all()):
            raise AssertionError(f"remat {tag}: non-finite outputs")
        r = {"eager_ms": eager_ms, "eager_tokens_s": B * T / eager_ms * 1e3,
             "eager_peak_gib": eager_peak / 2**30, "multi_ms": multi_ms,
             "multi_tokens_s": B * T / multi_ms * 1e3,
             "multi_peak_gib": multi_peak / 2**30,
             "flash_launches_per_step": launches}
        log(f"[remat] {tag}: eager {eager_ms:.2f} ms a step "
            f"({r['eager_tokens_s']:.1f} tokens/s, peak allocated "
            f"{r['eager_peak_gib']:.2f} GiB), step_multi({REMAT_K}) "
            f"{multi_ms:.2f} ms ({r['multi_tokens_s']:.1f} tokens/s, peak "
            f"{r['multi_peak_gib']:.2f} GiB); flash launches a step "
            f"{launches}; {smi}")
        return r

    # what earlier phases left (a failed capture's frames hold a graph
    # pool until the collector runs) is released first
    gc.collect()
    torch.cuda.empty_cache()
    mxrandom.seed(0)
    plain = trainer(False)
    init = {k: v.clone() for k, v in plain.params.items()}
    o_p = plain.step(data=data, softmax_label=label)[0].clone()
    m_p = moments(plain)
    res = {"plain": route(plain, "remat=False")}
    del plain
    torch.cuda.empty_cache()
    rem = trainer(True, params=init)
    o_r = rem.step(data=data, softmax_label=label)[0]
    out_err, (m_err, m_key) = agree(o_r, moments(rem), o_p, m_p)
    del o_p, m_p
    # the main path's run: every kernel count starts at 0 here
    _kernel_launches(reset=True)
    res["remat"] = route(rem, "remat=True")
    launches = _kernel_launches()
    del rem
    torch.cuda.empty_cache()
    per = res["remat"]["flash_launches_per_step"]
    if per != {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}:
        raise AssertionError(f"remat: flash launches a step {per}; want "
                             f"{2 * L} forwards, {L} dQ and {L} dK/dV")
    if any(launches[k] for k in launches if not k.startswith("flash")):
        raise AssertionError(f"remat launched {launches}")
    # Dropout: the recompute must replay the forward's masks
    drop = {}
    for tag, remat, seed in (("remat", True, 7), ("plain", False, 7),
                             ("plain, another seed", False, 8)):
        t = trainer(remat, REMAT_DROPOUT, init)
        mxrandom.seed(seed)
        o = t.step(data=data, softmax_label=label)[0].clone()
        drop[tag] = (o, moments(t))
        del t
        torch.cuda.empty_cache()
    same = agree(*drop["remat"], *drop["plain"])
    other = agree(*drop["plain, another seed"], *drop["plain"])
    del drop, init
    torch.cuda.empty_cache()
    log(f"[remat-parity] one step from the same weights, remat=True vs "
        f"remat=False: softmax output rel err {out_err:.3g} (tol 1e-2), Adam "
        f"first moment rel err max {m_err:.3g} ({m_key}; tol 5e-2); dropout "
        f"{REMAT_DROPOUT}, same generator state: output {same[0]:.3g}, "
        f"moment max {same[1][0]:.3g} ({same[1][1]}); plain from another "
        f"seed: output {other[0]:.3g}, moment max {other[1][0]:.3g}; {smi}")
    if not (out_err <= 1e-2 and m_err <= 5e-2):
        raise AssertionError(f"remat vs plain: {out_err}, {m_err} {m_key}")
    if not (same[0] <= 1e-2 and same[1][0] <= 5e-2):
        raise AssertionError(f"remat with dropout vs plain: {same}")
    if not other[1][0] > 10 * same[1][0]:
        raise AssertionError(f"dropout masks do not move the moments: "
                             f"{other} vs {same}")
    res.update(parity_out=out_err, parity_moment=m_err,
               dropout_same=same[1][0], dropout_other=other[1][0],
               launches=launches)
    log(f"[remat] {json.dumps(res)}")
    return launches, res

# ----------------------------------------------------- phases 24-26
# (a) ResNet-50 through mx.model.FeedForward at phase_module_resnet's
# cell (batch 256, fp32 with TF32 off, SGD lr 0.05 momentum 0.9, seeded
# He-normal weights): 2 warm-up and 10 timed batches of fit over a
# DataIter of device-resident batches, one epoch of 4 batches from
# numpy arrays, score and predict over 2 batches
FF_BATCH, FF_WARMUP, FF_STEPS = MODULE_BATCH, 2, 10
FF_NUMPY_BATCHES, FF_SCORE_BATCHES = 4, 2
FF_OPT = {"learning_rate": 0.05, "momentum": 0.9}
# the executor manager's step against Module's, from the same weights and
# batch with cuDNN deterministic: the same executor and optimizer code,
# so the parameters' largest error relative to their norms is held to
# 1e-6
FF_MANAGER_TOL = 1e-6
# (b) custom_softmax.py's numpy softmax head against SoftmaxOutput, one
# step's parameter gradients from the same weights and batch.  The head
# gradients differ by numpy's float32 exp/sum against the card's (a few
# ulps of p - onehot); propagated through 50 layers in fp32 (TF32 off)
# the gradients of all parameters, as one vector, are held to 1e-4 of
# its norm and the median parameter's to 1e-5 of its own.  A single
# parameter's error is printed but not held: the first BatchNorm's gamma
# gradient is a sum that cancels to a small remainder, where those
# roundings weigh (0.035 of its norm at batch 2 on the CPU)
CUSTOM_GRAD_TOL = (1e-4, 1e-5)
# (c) the LM's step (slice 2's cell) with the profiler off and on
PROF_STEPS = 3
PROF_TOP = 10


def _ff_symbols():
    """ResNet-50 (1000 classes, 224 x 224) with its SoftmaxOutput head,
    the same net with custom_softmax.py's numpy softmax as the head
    (``op_type="softmax"``, the same argument names), and seeded weights
    on the card."""
    from mxnet_tpu_torch import models, symbol as tsym
    from mxnet_tpu_torch.models import resnet

    _register_numpy_softmax()
    net = models.get_symbol("resnet-50", num_classes=1000,
                            image_shape=(3, 224, 224))
    logits = tsym.Symbol([net._outputs[0][0].inputs[0]])
    custom = tsym.Custom(logits, tsym.Variable("softmax_label"),
                         name="softmax", op_type="softmax")
    arg, aux = resnet.random_params(net, seed=0,
                                    data=(FF_BATCH, 3, 224, 224))
    arg = {k: torch.from_numpy(v).cuda() for k, v in arg.items()}
    aux = {k: torch.from_numpy(v).cuda() for k, v in aux.items()}
    return net, custom, arg, aux


def _register_numpy_softmax():
    """examples/numpy-ops/custom_softmax.py's operator, registered in the
    port as ``op_type="softmax"``: numpy forward and backward on the
    host."""
    import mxnet_tpu_torch as mx

    class Softmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], mx.nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().ravel().astype(int)
            y = out_data[0].asnumpy().copy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], mx.nd.array(y))

    @mx.operator.register("softmax")
    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()


def _ff_batches(seed, n):
    """``n`` seeded batches on the card: ``(data, label)`` tensors."""
    rs = np.random.RandomState(seed)
    return [(torch.from_numpy(rs.uniform(0, 1, (FF_BATCH, 3, 224, 224))
                              .astype(np.float32)).cuda(),
             torch.from_numpy(rs.randint(0, 1000, FF_BATCH)
                              .astype(np.float32)).cuda())
            for _ in range(n)]


def _resident_iter(batches, n):
    """A DataIter of ``n`` batches cycling over device-resident
    ``batches``."""
    from mxnet_tpu_torch import io
    from mxnet_tpu_torch.ndarray import NDArray

    class Resident(io.DataIter):
        def __init__(self):
            super().__init__()
            self.batch_size = int(batches[0][0].shape[0])
            self.provide_data = [("data", tuple(batches[0][0].shape))]
            self.provide_label = [("softmax_label",
                                   tuple(batches[0][1].shape))]
            self.k = 0

        def reset(self):
            self.k = 0

        def next(self):
            if self.k >= n:
                raise StopIteration
            x, y = batches[self.k % len(batches)]
            self.k += 1
            return io.DataBatch(data=[NDArray(x)], label=[NDArray(y)],
                                pad=0)

    return Resident()


def _ff_fit(net, arg, aux, batches, tag, smi):
    """``FeedForward.fit`` over ``FF_WARMUP + FF_STEPS`` resident
    batches: images/s and ms a batch over the timed ones (host stamps at
    each batch end, the last after a sync), host syncs between batches
    (``_SyncCounter``), and the Custom op's own calls and syncs."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import custom as tcustom

    model = mx.model.FeedForward(net, ctx=mx.gpu(0), num_epoch=1,
                                 numpy_batch_size=FF_BATCH,
                                 arg_params=arg, aux_params=aux,
                                 optimizer="sgd", **FF_OPT)
    it = _resident_iter(batches, FF_WARMUP + FF_STEPS)
    torch.cuda.synchronize()
    tcustom.reset_stats()
    t0 = time.perf_counter()
    with _SyncCounter() as sync:
        model.fit(it, eval_metric="acc", batch_end_callback=[sync.mark])
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    custom = tcustom.stats()
    marks = sync.marks
    per_batch = [b - a for a, b in zip(marks, marks[1:])]
    timed = t_end - sync.stamps[FF_WARMUP - 1]
    r = {"img_s": FF_BATCH * FF_STEPS / timed,
         "step_ms": timed / FF_STEPS * 1e3, "wall_s": t_end - t0,
         "syncs_per_batch": per_batch, "first_batch_syncs": marks[0],
         "custom": custom}
    log(f"[{tag}] FeedForward.fit over {FF_WARMUP} + {FF_STEPS} "
        f"device-resident batches of {FF_BATCH} x 3 x 224 x 224 (fp32, "
        f"TF32 off, SGD lr 0.05 momentum 0.9): {r['img_s']:.2f} img/s, "
        f"{r['step_ms']:.2f} ms a batch over the last {FF_STEPS}; host "
        f"syncs between batches {per_batch} (before the first batch's end "
        f"{marks[0]}; {', '.join(sorted(set(sync.syncs)))}; sync-debug "
        f"warnings {len(sync.warned())}); Custom op {json.dumps(custom)}; "
        f"{smi}")
    if len(marks) != FF_WARMUP + FF_STEPS:
        raise AssertionError(f"{tag}: {len(marks)} batches")
    return model, r


def phase_feedforward(smi):
    """(a) ResNet-50 through ``mx.model.FeedForward``: ``fit`` over
    device-resident batches (0 host syncs a batch), an epoch from numpy
    arrays, ``score`` and ``predict`` with each epilogue launch held
    against the plain version, ``save``/``load``/``predict`` identical,
    and one step through ``DataParallelExecutorManager`` equal to
    Module's.  Returns the numbers, the seeded weights (for phase 25)
    and the epilogue launches of the phase's main path."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.executor_manager import DataParallelExecutorManager

    gc.collect()
    torch.cuda.empty_cache()
    net, custom, arg, aux = _ff_symbols()
    batches = _ff_batches(0, 2)
    # the main path's run: every kernel count starts at 0 here
    _kernel_launches(reset=True)
    model, fit = _ff_fit(net, arg, aux, batches, "feedforward", smi)
    if any(fit["syncs_per_batch"]):
        raise AssertionError(f"FeedForward.fit made host syncs per batch: "
                             f"{fit['syncs_per_batch']}")
    # one epoch from numpy arrays: NDArrayIter, shuffled, last batch
    # discarded
    rs = np.random.RandomState(1)
    n = FF_BATCH * FF_NUMPY_BATCHES
    extra = max(1, FF_BATCH // 32)      # a partial batch, discarded
    X = rs.uniform(0, 1, (n + extra, 3, 224, 224)).astype(np.float32)
    y = rs.randint(0, 1000, n + extra).astype(np.float32)
    trained = (model.arg_params, model.aux_params)
    model._module = None
    del model
    gc.collect()
    torch.cuda.empty_cache()
    npm = mx.model.FeedForward(net, ctx=mx.gpu(0), num_epoch=1,
                               numpy_batch_size=FF_BATCH,
                               arg_params=trained[0], aux_params=trained[1],
                               optimizer="sgd", **FF_OPT)
    batches_seen = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    npm.fit(X, y, batch_end_callback=lambda p: batches_seen.append(p.nbatch))
    torch.cuda.synchronize()
    np_wall = time.perf_counter() - t0
    del X, y
    log(f"[feedforward-numpy] FeedForward.fit over a numpy X of "
        f"{n + extra} images (numpy_batch_size {FF_BATCH}: "
        f"{len(batches_seen)} batches, the last {extra} images discarded) "
        f"in {np_wall:.3f} s "
        f"({n / np_wall:.1f} img/s with the host batches' upload); {smi}")
    if len(batches_seen) != FF_NUMPY_BATCHES:
        raise AssertionError(f"numpy route ran {len(batches_seen)} batches")
    # score and predict over 2 batches, every epilogue launch checked
    rs = np.random.RandomState(7)
    ne = FF_BATCH * FF_SCORE_BATCHES
    Xe = rs.uniform(0, 1, (ne, 3, 224, 224)).astype(np.float32)
    ye = rs.randint(0, 1000, ne).astype(np.float32)
    n0 = _kernel_launches()["residual_epilogue"]
    torch.backends.cudnn.deterministic = True
    try:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_ff_")
        try:
            with _EpilogueRecorder() as rec:
                acc = npm.score(Xe, ye)
                checked = rec.check("FeedForward.score")
                probs = npm.predict(Xe)
                checked += rec.check("FeedForward.predict")
                prefix = os.path.join(tmp, "resnet50")
                npm.save(prefix, 2)
                npm._module = None
                gc.collect()
                torch.cuda.empty_cache()
                loaded = mx.model.FeedForward.load(
                    prefix, 2, ctx=mx.gpu(0), numpy_batch_size=FF_BATCH)
                reloaded = loaded.predict(Xe)
                checked += rec.check("FeedForward.load -> predict")
                del loaded
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        launched = _kernel_launches()["residual_epilogue"] - n0
    finally:
        torch.backends.cudnn.deterministic = False
    main_launches = _kernel_launches()
    same = bool(np.array_equal(probs, reloaded))
    log(f"[feedforward-score] score over {FF_SCORE_BATCHES} batches: "
        f"accuracy {acc}; predict {probs.shape}; {launched} epilogue "
        f"launches in {3 * FF_SCORE_BATCHES} forwards (score, predict, the "
        f"reloaded model's predict), {checked} each held against the plain "
        f"version; save -> FeedForward.load -> predict "
        f"identical: {same} (max |diff| "
        f"{float(np.abs(probs - reloaded).max()):.3g}); {smi}")
    if launched != 4 * 3 * FF_SCORE_BATCHES or checked != launched:
        raise AssertionError(f"FeedForward score/predict: {launched} "
                             f"epilogue launches, {checked} checked")
    if probs.shape != (ne, 1000) or not same:
        raise AssertionError("FeedForward.load's predictions differ")
    if any(v for k, v in main_launches.items() if k != "residual_epilogue"):
        raise AssertionError(f"phase 24 launched {main_launches}")
    del npm, probs, reloaded, Xe
    gc.collect()
    torch.cuda.empty_cache()
    # one step through the executor manager against Module's
    x0, y0 = batches[0]
    it = _resident_iter(batches, 1)
    opt = dict(FF_OPT, rescale_grad=1.0 / FF_BATCH)
    torch.backends.cudnn.deterministic = True
    try:
        mgr = DataParallelExecutorManager(net, [mx.gpu(0)], it)
        mgr.set_params(arg, aux)
        upd = mx.optimizer.get_updater(mx.optimizer.create("sgd", **opt))
        mgr.load_data_batch(next(iter(it)))
        mgr.forward(is_train=True)
        mgr.backward()
        for i, (w, g) in enumerate(zip(mgr.param_arrays, mgr.grad_arrays)):
            upd(i, g[0], w[0])
        got = {}
        mgr.copy_to(got, {})
        got = {k: v.tensor for k, v in got.items()}
        del mgr
        torch.cuda.empty_cache()
        mod = mx.mod.Module(net, context=mx.gpu(0))
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(arg_params=arg, aux_params=aux)
        mod.init_optimizer(kvstore=None, optimizer="sgd",
                           optimizer_params=opt)
        _module_step(mod, _batch(x0, y0))
        want = {k: v.tensor for k, v in mod.get_params()[0].items()}
        del mod
    finally:
        torch.backends.cudnn.deterministic = False
    err, key, med = _rel_errs(got, want)
    diff = max(float((got[k] - want[k]).abs().max()) for k in want)
    log(f"[feedforward-manager] one SGD step through "
        f"DataParallelExecutorManager (forward, backward, the Updater over "
        f"param_arrays/grad_arrays) vs Module's step, same weights and "
        f"batch: parameters max |diff| {diff:.3g}, max rel err {err:.3g} "
        f"({key}), median {med:.3g} (tol {FF_MANAGER_TOL}); {smi}")
    if not err <= FF_MANAGER_TOL:
        raise AssertionError(f"executor manager vs Module: {err} ({key})")
    del got, want
    torch.cuda.empty_cache()
    res = {"fit": fit, "numpy_img_s": n / np_wall, "score": acc,
           "epilogue_launches": launched, "epilogue_checked": checked,
           "reload_identical": same, "manager_rel_err": err,
           "manager_max_abs": diff}
    log("[feedforward] " + json.dumps(res))
    return res, (net, custom, arg, aux, batches), main_launches


def _grads(net, arg, aux, x, y):
    """One training forward and backward of ``net`` bound at ``x``'s
    shape from ``arg``/``aux``: the parameters' gradients (clones)."""
    ex = net.simple_bind("cuda", data=tuple(x.shape),
                         softmax_label=tuple(y.shape))
    ex.copy_params_from(arg, aux)
    ex.forward(is_train=True, data=x, softmax_label=y)
    ex.backward()
    grads = {k: ex.grad_dict[k].clone() for k in arg}
    del ex
    torch.cuda.empty_cache()
    return grads


def phase_custom_op(smi, ff, fit_ref):
    """(b) The same net and batch with custom_softmax.py's numpy softmax
    as the head through ``FeedForward.fit`` (10 timed batches): step ms
    against the SoftmaxOutput head of phase 24, the op's host ms and
    host syncs a batch, one step's parameter gradients against the
    SoftmaxOutput head's, and ``step_multi``'s refusal.  Returns the
    numbers and the kernel launches of its fit (none)."""
    from mxnet_tpu_torch.ops import custom as tcustom
    from mxnet_tpu_torch.trainer import FusedTrainer

    net, custom, arg, aux, batches = ff
    gc.collect()
    torch.cuda.empty_cache()
    _kernel_launches(reset=True)
    model, fit = _ff_fit(custom, arg, aux, batches, "custom_op", smi)
    launches = _kernel_launches()
    model._module = None
    del model
    gc.collect()
    torch.cuda.empty_cache()
    calls = fit["custom"]
    per_batch = {"syncs": calls["syncs"] / (FF_WARMUP + FF_STEPS),
                 "host_ms": calls["host_s"] * 1e3 / (FF_WARMUP + FF_STEPS)}
    per_batch["wait_ms"] = calls["wait_s"] * 1e3 / (FF_WARMUP + FF_STEPS)
    log(f"[custom_op] step {fit['step_ms']:.2f} ms with the numpy head vs "
        f"{fit_ref['step_ms']:.2f} ms with SoftmaxOutput "
        f"({fit['step_ms'] / fit_ref['step_ms']:.4f}x); the op per batch: "
        f"{per_batch['syncs']:.1f} host syncs (download of its inputs, one "
        f"each way), {per_batch['host_ms']:.3f} host ms in the op, of which "
        f"{per_batch['wait_ms']:.3f} waiting in the syncs for the queued "
        f"work and {per_batch['host_ms'] - per_batch['wait_ms']:.3f} "
        f"copying, in numpy and uploading (forward {calls['forward']}, "
        f"backward {calls['backward']} calls in {FF_WARMUP + FF_STEPS} "
        f"batches); {smi}")
    if (calls["forward"], calls["backward"]) != ((FF_WARMUP + FF_STEPS),) * 2 \
            or per_batch["syncs"] != 2:
        raise AssertionError(f"Custom op calls {calls}")
    if any(launches.values()):
        raise AssertionError(f"phase 25 launched {launches}")
    # one step's gradients against the SoftmaxOutput head
    x, y = batches[0]
    torch.backends.cudnn.deterministic = True
    try:
        want = _grads(net, arg, aux, x, y)
        got = _grads(custom, arg, aux, x, y)
    finally:
        torch.backends.cudnn.deterministic = False
    err, key, med = _rel_errs(got, want)
    whole = float(torch.sqrt(sum(((got[k] - want[k]).double() ** 2).sum()
                                 for k in want))
                  / torch.sqrt(sum((want[k].double() ** 2).sum()
                                   for k in want)))
    log(f"[custom_op-grads] one step's parameter gradients, numpy head vs "
        f"SoftmaxOutput, same weights and batch: all parameters as one "
        f"vector rel err {whole:.3g}, median parameter {med:.3g} (tol "
        f"{CUSTOM_GRAD_TOL}); the largest {err:.3g} ({key}); {smi}")
    if not (whole <= CUSTOM_GRAD_TOL[0] and med <= CUSTOM_GRAD_TOL[1]):
        raise AssertionError(f"Custom head gradients: {whole}, {med}")
    del got, want
    torch.cuda.empty_cache()
    tr = FusedTrainer(custom, optimizer="sgd", optimizer_params={
        "lr": FF_OPT["learning_rate"]}).init(data=(FF_BATCH, 3, 224, 224))
    try:
        tr.step_multi(data=torch.stack([x, x]), softmax_label=torch.stack([
            y, y]))
    except Exception as exc:  # noqa: BLE001 — the refusal is the check
        refusal = f"{type(exc).__name__}: {exc}"
    else:
        raise AssertionError("step_multi ran a graph with a Custom op")
    del tr
    torch.cuda.empty_cache()
    log(f"[custom_op-step_multi] {refusal}")
    if not ("MXNetError" in refusal and "softmax" in refusal
            and "step()" in refusal):
        raise AssertionError(f"step_multi's refusal: {refusal}")
    res = {"step_ms": fit["step_ms"], "img_s": fit["img_s"],
           "vs_softmax_output": fit["step_ms"] / fit_ref["step_ms"],
           "syncs_per_batch": per_batch["syncs"],
           "host_ms_per_batch": per_batch["host_ms"],
           "sync_wait_ms_per_batch": per_batch["wait_ms"],
           "grad_rel_err_whole": whole, "grad_rel_err_median": med,
           "grad_rel_err_max": [key, err], "refusal": refusal}
    log("[custom_op] " + json.dumps(res))
    return res, launches


# each flash launch of a profiled LM step against the plain version:
# every value within 1e-2 absolute and relative (as flash_check), and
# each 64-row tile within these fractions of its norm.  The forward's O
# is held as flash_check holds it.  dQ and dK/dV are sums over dS = P *
# (dP - delta), whose rows sum to zero: with the step's real head
# gradients the terms cancel to a remainder far below their size, and
# the kernels' bf16 rounding of dS (2^-9 of each term, the tensor cores'
# A operand) weighs more against that remainder than with flash_check's
# unit-normal dO (1.47e-2 of a dQ tile in this PR's first chip call).
# A tile left out is off by its whole norm.
FLASH_STEP_TILE_TOL = {"flash_fwd": 1e-2, "flash_bwd_dq": 5e-2,
                       "flash_bwd_dkv": 5e-2}


class _FlashRecorder:
    """Within ``with``, every launch of the three flash kernels is
    recorded with its inputs and outputs; :meth:`check` holds each
    against the plain version (``FLASH_STEP_TILE_TOL``), then forgets
    them; :attr:`tiles` keeps each kernel's worst tile error."""

    def __init__(self):
        from mxnet_tpu_torch.ops import flash_attention as fa

        self.fa, self.calls, self.tiles = fa, [], {}
        self.kernels = (fa._cuda_fwd, fa._cuda_dq, fa._cuda_dkv)

    def _wrap(self, name, fn):
        def f(*args):
            out = fn(*args)
            self.calls.append((name, args, out))
            return out
        return f

    def __enter__(self):
        fa = self.fa
        fa._cuda_fwd = self._wrap("flash_fwd", self.kernels[0])
        fa._cuda_dq = self._wrap("flash_bwd_dq", self.kernels[1])
        fa._cuda_dkv = self._wrap("flash_bwd_dkv", self.kernels[2])
        return self

    def __exit__(self, *exc):
        self.fa._cuda_fwd, self.fa._cuda_dq, self.fa._cuda_dkv = self.kernels
        return False

    @torch.no_grad()
    def check(self, what):
        fa, n = self.fa, {}
        calls, self.calls = self.calls, []
        for name, args, out in calls:
            if name == "flash_fwd":
                got, want = out[0], fa.fwd_plain(*args)[0]
                pairs = [(got, want)]
            elif name == "flash_bwd_dq":
                pairs = [(out, fa.dq_plain(*args))]
            else:
                pairs = list(zip(out, fa.dkv_plain(*args)))
            for got, want in pairs:
                diff = (got.float() - want.float()).abs()
                tile = tile_rel_err(got, want)
                self.tiles[name] = max(self.tiles.get(name, 0.0), tile)
                if bool((diff > 1e-2 + 1e-2 * want.float().abs()).any()) \
                        or tile > FLASH_STEP_TILE_TOL[name]:
                    raise AssertionError(
                        f"{what}: {name} launch at {tuple(got.shape)}: max "
                        f"abs err {float(diff.max())}, tile {tile}")
            n[name] = n.get(name, 0) + 1
        return n


def _trace_kernels(path, steps, update="FusedTrainer.update"):
    """``({kernel name: device ms a step}, the same for the kernels that
    start inside the ``update`` range's spans on the device)`` from a
    torch.profiler chrome trace (its ``kernel`` and
    ``gpu_user_annotation`` events)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "gpu_user_annotation"
             and e.get("name") == update]
    rows, in_update = {}, {}
    for e in events:
        if e.get("cat") == "kernel":
            ms = e["dur"] / 1e3 / steps
            rows[e["name"]] = rows.get(e["name"], 0.0) + ms
            if any(a <= e["ts"] < b for a, b in spans):
                in_update[e["name"]] = in_update.get(e["name"], 0.0) + ms
    return rows, in_update


def phase_profiler(smi):
    """(c) ``transformer_lm(**MFU_HEADLINE_CONFIG)`` through
    ``FusedTrainer`` (bf16, Adam lr 1e-4, batch 8 x 1024, eager steps):
    3 steps with the profiler off, 3 under ``profiler_set_config(mode=
    "symbolic", xla_trace_dir=...)`` (the first step's flash launches
    each held against the plain version), the spans, both files and the
    step's elementwise device time by kernel from the device trace; then
    ``nd`` ops under ``mode="all"``.  Returns the numbers and the flash
    launches of the phase's main path."""
    from mxnet_tpu_torch import ndarray as tnd
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.models import transformer as tr
    from mxnet_tpu_torch.trainer import FusedTrainer

    cfg = tr.MFU_HEADLINE_CONFIG
    B, T, V, L = TRAIN_BATCH, cfg["seq_len"], cfg["vocab_size"], \
        cfg["num_layers"]
    gc.collect()
    torch.cuda.empty_cache()
    mxrandom.seed(0)
    tk = FusedTrainer(tr.transformer_lm(**cfg), optimizer="adam",
                      optimizer_params={"lr": 1e-4}, dtype="bfloat16").init(
        data=(B, T), softmax_label=(B, T))
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.integers(0, V, (B, T)).astype(np.float32))
    label = torch.from_numpy(rng.integers(0, V, (B, T)).astype(np.float32))
    tk.step(data=data, softmax_label=label)
    torch.cuda.synchronize()
    # the main path's run: every kernel count starts at 0 here
    _kernel_launches(reset=True)

    def steps(n, recorder=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            if recorder is not None and i == 0:
                with recorder:
                    tk.step(data=data, softmax_label=label)
            else:
                tk.step(data=data, softmax_label=label)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    off_ms = steps(PROF_STEPS)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_profiler_")
    try:
        fname = os.path.join(tmp, "profile.json")
        tdir = os.path.join(tmp, "trace")
        profiler.profiler_set_config(mode="symbolic", filename=fname,
                                     xla_trace_dir=tdir)
        rec = _FlashRecorder()
        profiler.profiler_set_state("run")
        try:
            on_ms = steps(PROF_STEPS, rec)
        finally:
            profiler.profiler_set_state("stop")
        t0 = time.perf_counter()
        checked = rec.check("profiled LM step")
        check_s = time.perf_counter() - t0
        launches = _kernel_launches()
        profiler.dump_profile()
        trace = profiler.device_trace_files()[-1]
        with open(fname) as f:
            spans = [e for e in json.load(f)["traceEvents"]
                     if e["name"].startswith("forward_backward[")]
        sizes = {"profile_json": os.path.getsize(fname),
                 "device_trace": os.path.getsize(trace)}
        kernels, in_update = _trace_kernels(trace, PROF_STEPS)
        # the mode="all" half: imperative nd ops on the card
        fname2 = os.path.join(tmp, "profile_all.json")
        profiler.profiler_set_config(mode="all", filename=fname2)
        a = tnd.array(np.ones((1024, 1024), np.float32), ctx="cuda")
        profiler.profiler_set_state("run")
        try:
            tnd.sum(tnd.exp(tnd.dot(a, a))).wait_to_read()
        finally:
            profiler.profiler_set_state("stop")
            profiler.profiler_set_config()
        profiler.dump_profile(fname2)
        with open(fname2) as f:
            imperative = sorted(e["name"] for e in json.load(f)["traceEvents"]
                                if e["cat"] == "imperative")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del tk
    torch.cuda.empty_cache()
    flash = {k: v for k, v in kernels.items() if "flash_" in k}
    elementwise = sorted(((t, k) for k, t in kernels.items()
                          if "elementwise" in k), reverse=True)
    busy = sum(kernels.values())
    ew_total = sum(t for t, _ in elementwise)
    ew_update = sum(t for k, t in in_update.items() if "elementwise" in k)
    log(f"[profiler] LM step (bf16, batch {B} x {T}, eager): profiler off "
        f"{off_ms:.2f} ms, on (mode symbolic, device trace) {on_ms:.2f} ms "
        f"({on_ms / off_ms:.4f}x); {len(spans)} forward_backward spans; "
        f"profile.json {sizes['profile_json']} bytes, device trace "
        f"{sizes['device_trace']} bytes; {len(kernels)} kernel names in the "
        f"trace, device busy {busy:.2f} ms a step; flash kernels in the "
        f"trace {sorted(flash)}; the first profiled step's flash launches "
        f"held against the plain versions {checked} ({check_s:.1f} s; "
        f"worst tile error by kernel {json.dumps(rec.tiles)}, tol "
        f"{json.dumps(FLASH_STEP_TILE_TOL)}); launches {launches}; {smi}")
    log(f"[profiler-elementwise] the step's elementwise kernels "
        f"{ew_total:.3f} ms a step ({len(elementwise)} names) of "
        f"{busy:.2f} ms busy, {ew_update:.3f} of them inside "
        f"FusedTrainer.update (all its kernels "
        f"{sum(in_update.values()):.3f} ms); the {PROF_TOP} largest (ms a "
        f"step, of which in the update): "
        + "; ".join(f"{k[:160]} {t:.3f} ({in_update.get(k, 0.0):.3f})"
                    for t, k in elementwise[:PROF_TOP]) + f"; {smi}")
    log(f"[profiler-all] mode='all' imperative spans {imperative}")
    want = {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    per_step = {k: launches[k] / (2 * PROF_STEPS) for k in want}
    if per_step != want or checked != want:
        raise AssertionError(f"profiled LM steps: launches {launches}, "
                             f"checked {checked}")
    if any(launches[k] for k in launches if not k.startswith("flash")):
        raise AssertionError(f"phase 26 launched {launches}")
    if len(spans) != PROF_STEPS or not all(sizes.values()):
        raise AssertionError(f"profiler files: {len(spans)} spans, {sizes}")
    for pat in ("flash_fwd", "flash_dq", "flash_dkv"):
        if not any(pat in k for k in flash):
            raise AssertionError(f"the device trace names no {pat} kernel: "
                                 f"{sorted(flash)}")
    if imperative != ["dot", "exp", "sum"]:
        raise AssertionError(f"mode='all' spans {imperative}")
    res = {"off_ms": off_ms, "on_ms": on_ms, "spans": len(spans),
           "sizes": sizes, "busy_ms": busy, "elementwise_ms": ew_total,
           "elementwise_update_ms": ew_update,
           "update_ms": sum(in_update.values()),
           "elementwise_top": [[k, t, in_update.get(k, 0.0)]
                               for t, k in elementwise[:PROF_TOP]],
           "flash_ms": flash, "flash_checked": checked,
           "flash_tile_err": rec.tiles, "launches": launches,
           "imperative": imperative}
    log("[profiler] " + json.dumps(res))
    return res, launches


# --------------------------------------------------------------- phase 27
SERVE_INT8_TOKENS = 32
AGREE_PROMPT, AGREE_TOKENS = 64, 64


def _serve_burst(port, prompts, max_tokens, workers=None):
    """``prompts`` posted concurrently as greedy requests; every reply
    must be a 200 "ok" with ``max_tokens`` tokens in the vocab."""
    with ThreadPoolExecutor(workers or len(prompts)) as ex:
        replies = list(ex.map(lambda p: _post(port, {
            "prompt": p, "max_tokens": max_tokens, "temperature": 0,
            "deadline_ms": 600000}), prompts))
    for i, (st, body) in enumerate(replies):
        if st != 200 or body.get("outcome") != "ok" \
                or body.get("n_tokens") != max_tokens:
            raise AssertionError(f"request {i} (prompt {len(prompts[i])}): "
                                 f"HTTP {st} {body}")
    return replies


def phase_serve_int8(cfg, params, smi):
    """The served LM with int8 weights, bf16 compute, paged, through the
    kernel.  Returns (main-path launches by kernel, the bf16 decoder)."""
    from mxnet_tpu_torch import telemetry as tm
    from mxnet_tpu_torch.models.decode import KVDecoder
    from mxnet_tpu_torch.serving import serve_decoder
    from mxnet_tpu_torch.serving.paged_kv import PagedSlots

    V, L = cfg["vocab_size"], cfg["num_layers"]
    kw = dict(num_layers=L, num_heads=cfg["num_heads"], max_len=MAX_LEN,
              dtype=torch.bfloat16)
    tm.enable()
    t0 = time.perf_counter()
    dec8 = KVDecoder(params, quantize="int8", **kw)
    build8 = time.perf_counter() - t0
    dec16 = KVDecoder(params, **kw)
    b8, b16 = dec8.weight_bytes(), dec16.weight_bytes()
    log(f"[serve_int8] int8 decoder built in {build8:.1f} s (host "
        f"quantization); weight bytes on the card: int8 {b8 / 1e9:.4f} GB "
        f"against bf16 {b16 / 1e9:.4f} GB ({b8 / b16:.4f}); {smi}")
    if not b8 < 0.6 * b16:
        raise AssertionError(f"int8 weights {b8} B, bf16 {b16} B")
    # the kernel against its plain version on the same int8 state (these
    # launches are the check's, outside the main path's counts)
    buckets = tuple(2 ** i for i in range(3, 11))
    ref, fed = _drive(PagedSlots(dec8, 3, block=BLOCK,
                                 prefill_buckets=buckets, kernel="gather"), V)
    ker_pg = PagedSlots(dec8, 3, block=BLOCK, prefill_buckets=buckets,
                        kernel="auto")
    if ker_pg.kernel != "cuda":
        raise AssertionError(f"auto picked {ker_pg.kernel!r}")
    got, _ = _drive(ker_pg, V, forced=fed)
    del ker_pg
    errs = [float(np.abs(a - b).max()) for a, b in zip(ref, got)]
    # phase_parity's bf16 tolerances: under one bf16 ulp at magnitude 2
    # on the first kernel step, three ulps' room after it
    log(f"[serve_int8-parity] {len(ref)} emissions, max |kernel - gather| "
        f"logits {max(errs):.3g} (atol 0.1; first step {errs[1]:.3g}, atol "
        f"1e-2)")
    if not (errs[1] <= 1e-2 and max(errs) <= 1e-1):
        raise AssertionError(f"int8 kernel vs gather logits: {errs}")
    server, sched = serve_decoder(dec8, num_slots=SLOTS, paged=True,
                                  kv_block=BLOCK, queue_size=32)
    try:
        port = server.server_address[1]
        if sched.backend.kernel != "cuda":
            raise AssertionError(f"paged backend picked "
                                 f"{sched.backend.kernel!r}, not the kernel")
        _serve_burst(port, [[1, 2, 3]], 2)          # warm-up
        rng = np.random.default_rng(11)
        prompts = [rng.integers(0, V, int(n)).tolist()
                   for n in rng.integers(16, 701, 16)]
        tick_hist = tm.get_registry().get("serve_tick_seconds")
        tsum0, tcnt0 = tick_hist.sum(), tick_hist.count()
        tick0 = sched.stats["ticks"]
        # the main path's run: every kernel count starts at 0 here
        _kernel_launches(reset=True)
        t0 = time.perf_counter()
        replies = _serve_burst(port, prompts, SERVE_INT8_TOKENS)
        wall = time.perf_counter() - t0
        launches = _kernel_launches()
        ticks = sched.stats["ticks"] - tick0
    finally:
        server.shutdown()
        server.server_close()
        sched.close()
    if launches["paged_attention"] < ticks * L or ticks < 1:
        raise AssertionError(f"int8 serving: {launches} launches in "
                             f"{ticks} ticks x {L} layers")
    ttft = sorted(r[1]["ttft_ms"] for r in replies)
    n_tok = sum(r[1]["n_tokens"] for r in replies)
    tick_ms = (tick_hist.sum() - tsum0) / max(tick_hist.count() - tcnt0,
                                             1) * 1e3
    tick = tick_profile(dec8, tag="serve_int8-tick")
    # greedy agreement with the bf16 decoder (reported, not asserted:
    # int8 rounding moves near-tied logits)
    prompt = np.random.default_rng(12).integers(0, V, (SLOTS, AGREE_PROMPT))
    a8 = dec8.generate_scan(prompt, AGREE_TOKENS)
    a16 = dec16.generate_scan(prompt, AGREE_TOKENS)
    same = float((a8 == a16).mean())
    prefix = float(np.mean([np.argmin(np.append(r8 == r16, False))
                            for r8, r16 in zip(a8, a16)]))
    out = {"weight_bytes_int8": b8, "weight_bytes_bf16": b16,
           "tokens_per_s": n_tok / wall,
           "ttft_p50_ms": float(np.percentile(ttft, 50)),
           "ttft_p99_ms": float(np.percentile(ttft, 99)),
           "tick_ms": tick_ms, "tick_wall_ms": tick["wall_ms"],
           "idle_share": tick["idle_share"], "ticks": ticks,
           "kernel_vs_gather": max(errs), "greedy_agreement": same,
           "agreeing_prefix": prefix, "launches": launches}
    log(f"[serve_int8] 16/16 ok, {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tok/s; TTFT p50 {out['ttft_p50_ms']:.1f} ms p99 "
        f"{out['ttft_p99_ms']:.1f} ms; {ticks} ticks, mean tick "
        f"{tick_ms:.2f} ms; paged kernel launches "
        f"{launches['paged_attention']}; greedy tokens equal to bf16's "
        f"{same:.4f} ({SLOTS} x {AGREE_TOKENS}, mean agreeing prefix "
        f"{prefix:.1f}); {smi}")
    log(f"[serve_int8] {json.dumps(out)}")
    del dec8
    torch.cuda.empty_cache()
    return launches, dec16


# --------------------------------------------------------------- phase 28
SCAN_BATCH, SCAN_PROMPT, SCAN_TOKENS = 8, 64, 256
BEAM_BATCH, BEAM_PROMPT, BEAM_TOKENS, BEAM_SIZE = 2, 32, 64, 4


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_generate(cfg, dec, smi):
    """``generate_scan`` against ``generate``, an early eos exit, and
    ``beam_search``, at full width in bf16.  Returns the counts of the
    scan's run (no hand-written kernel: the contiguous decoder)."""
    V = cfg["vocab_size"]
    rng = np.random.default_rng(13)
    prompt = rng.integers(0, V, (SCAN_BATCH, SCAN_PROMPT))
    dec.generate_scan(prompt, 4)                    # warm-up
    dec.generate(prompt, 4, temperature=0)
    _kernel_launches(reset=True)
    # the syncs counted in one run (sync debug mode slows every launch),
    # the rates timed in two more, scan and generate in turns
    with _SyncCounter() as sc:
        scan = dec.generate_scan(prompt, SCAN_TOKENS)
    launches = _kernel_launches()
    syncs = len(sc.warned())
    _, t_scan = _timed(lambda: dec.generate_scan(prompt, SCAN_TOKENS))
    ref, t_gen = _timed(lambda: dec.generate(prompt, SCAN_TOKENS,
                                             temperature=0))
    if not np.array_equal(scan, ref):
        bad = np.argwhere(scan != ref)[0]
        raise AssertionError(f"generate_scan differs from generate at "
                             f"{tuple(bad)}")
    if dec.last_scan_syncs != 1 or syncs > 4:
        raise AssertionError(f"generate_scan: {dec.last_scan_syncs} reads "
                             f"of the device, {syncs} synchronising calls")
    n = SCAN_BATCH * SCAN_TOKENS
    # eos: every row the same prompt, so every row ends together on the
    # first token the greedy run emits for the first time at position 5
    # or later, and the loop stops at its next check
    same = np.repeat(prompt[:1], SCAN_BATCH, axis=0)
    free = dec.generate_scan(same, SCAN_TOKENS)
    j = next((j for j in range(5, SCAN_TOKENS)
              if free[0, j] not in free[0, :j]), 5)
    eos = int(free[0, j])
    cut = int(np.argmax(free[0] == eos)) + 1
    with _SyncCounter() as sc:
        eos_out, t_eos = _timed(lambda: dec.generate_scan(
            same, SCAN_TOKENS, eos_id=eos))
    if not (np.array_equal(eos_out[:, :cut], free[:, :cut])
            and (eos_out[:, cut:] == eos).all()):
        raise AssertionError("eos run is not the free run eos-padded")
    if dec.last_scan_syncs > 1 + -(-cut // 16) + 1:
        raise AssertionError(f"eos run read the device "
                             f"{dec.last_scan_syncs} times")
    # beam search: beam 1 is greedy (up to an exact tie of bf16 logits,
    # which numpy's argpartition and argmax may break apart), scores
    # sorted best-first
    bprompt = rng.integers(0, V, (BEAM_BATCH, BEAM_PROMPT))
    b1, _ = dec.beam_search(bprompt, BEAM_TOKENS, beam_size=1)
    greedy = dec.generate(bprompt, BEAM_TOKENS, temperature=0)
    ties = 0
    for r in range(BEAM_BATCH):
        diff = np.flatnonzero(b1[r, 0] != greedy[r])
        if diff.size:
            # the greedy run's own logits at the first difference
            j = int(diff[0])
            st, lg = dec.prefill(bprompt)
            lg = lg[:, -1]
            for i in range(j):
                st, lg = dec.step(st, greedy[:, i])
            lg = lg[r].float().cpu().numpy()
            if lg[b1[r, 0, j]] != lg[greedy[r, j]]:
                raise AssertionError(f"beam_search(beam_size=1) row {r} "
                                     f"leaves greedy at {j} without a tie")
            ties += 1
    (beams, scores), t_beam = _timed(lambda: dec.beam_search(
        bprompt, BEAM_TOKENS, beam_size=BEAM_SIZE))
    if beams.shape != (BEAM_BATCH, BEAM_SIZE, BEAM_TOKENS) or not (
            np.diff(scores, axis=1) <= 1e-6).all() \
            or not np.isfinite(scores).all():
        raise AssertionError(f"beam_search: {beams.shape} {scores}")
    out = {"scan_tokens_per_s": n / t_scan, "generate_tokens_per_s":
           n / t_gen, "scan_syncs": syncs, "scan_reads": 1,
           "eos_cut": cut, "eos_ms": t_eos * 1e3, "eos_reads":
           dec.last_scan_syncs, "eos_syncs": len(sc.warned()),
           "scan_ms": t_scan * 1e3, "beam_ms": t_beam * 1e3,
           "beam_tokens_per_s": BEAM_BATCH * BEAM_SIZE * BEAM_TOKENS / t_beam,
           "beam1_ties": ties, "launches": launches}
    log(f"[generate] generate_scan batch {SCAN_BATCH} x {SCAN_TOKENS} new "
        f"tokens: {n / t_scan:.1f} tok/s ({t_scan * 1e3:.1f} ms, "
        f"{syncs} synchronising calls, 1 read of the tokens) against "
        f"generate's {n / t_gen:.1f} tok/s ({t_gen * 1e3:.1f} ms), "
        f"token-equal; eos at position {cut}: {t_eos * 1e3:.1f} ms, "
        f"{dec.last_scan_syncs} reads; beam_search {BEAM_BATCH} x "
        f"{BEAM_SIZE} beams x {BEAM_TOKENS}: {t_beam * 1e3:.1f} ms, best "
        f"scores {scores[:, 0].round(3).tolist()}; {smi}")
    log(f"[generate] {json.dumps(out)}")
    return launches


# --------------------------------------------------------------- phase 29
ROUTER_REQUESTS, ROUTER_TOKENS, ROUTER_KILL_WAVE, ROUTER_BURST = 64, 16, 32, 8
ROUTER_LATENCY_CALLS = 16


def _latencies(ports, prompt, n):
    """ms of ``n`` sequential small requests to each port, in turns."""
    out = {port: [] for port in ports}
    for _ in range(n):
        for port in ports:
            t0 = time.perf_counter()
            st, body = _post(port, {"prompt": prompt, "max_tokens": 4,
                                    "temperature": 0})
            out[port].append((time.perf_counter() - t0) * 1e3)
            if st != 200 or body.get("outcome") != "ok":
                raise AssertionError(f"latency probe: HTTP {st} {body}")
    return [np.array(out[port]) for port in ports]


def phase_router(cfg, params, smi):
    """Two full-width bf16 replicas on the card behind the router.
    Returns the main path's launches by kernel."""
    from mxnet_tpu_torch import telemetry as tm
    from mxnet_tpu_torch.models.decode import KVDecoder
    from mxnet_tpu_torch.serving import (ReplicaRouter, serve_decoder,
                                         start_router)

    V, L = cfg["vocab_size"], cfg["num_layers"]
    tm.enable()
    reps = []
    for _ in range(2):
        dec = KVDecoder(params, num_layers=L, num_heads=cfg["num_heads"],
                        max_len=MAX_LEN, dtype=torch.bfloat16)
        server, sched = serve_decoder(dec, num_slots=SLOTS, paged=True,
                                      kv_block=BLOCK, queue_size=64)
        if sched.backend.kernel != "cuda":
            raise AssertionError(f"replica picked {sched.backend.kernel!r}")
        reps.append((dec, server, sched,
                     "127.0.0.1:%d" % server.server_address[1]))
    addrs = [r[3] for r in reps]
    router = ReplicaRouter(replicas=addrs, scrape_s=1.0, retries=2)
    rsrv = start_router(router, port=0)
    rport = rsrv.server_address[1]
    ref_server = ref_sched = None
    try:
        for r in reps:
            _serve_burst(int(r[3].rsplit(":", 1)[1]), [[1, 2, 3]], 2)
        rng = np.random.default_rng(14)
        prompts = [rng.integers(0, V, int(n)).tolist()
                   for n in rng.integers(16, 201, ROUTER_REQUESTS
                                         + ROUTER_KILL_WAVE + ROUTER_BURST)]
        wave1 = prompts[:ROUTER_REQUESTS]
        wave2 = prompts[ROUTER_REQUESTS:ROUTER_REQUESTS + ROUTER_KILL_WAVE]
        burst = prompts[ROUTER_REQUESTS + ROUTER_KILL_WAVE:]
        ticks0 = [r[2].stats["ticks"] for r in reps]
        retries = tm.get_registry().get("router_retries_total")
        r0 = retries.total()
        used = {}

        def routed(p):
            req = urllib.request.Request(
                f"http://127.0.0.1:{rport}/generate",
                data=json.dumps({"prompt": p, "max_tokens": ROUTER_TOKENS,
                                 "temperature": 0}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                body = json.loads(resp.read())
                return resp.status, body, resp.headers["X-MXTPU-Replica"]

        # the main path's run: every kernel count starts at 0 here
        _kernel_launches(reset=True)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(32) as ex:
            out1 = list(ex.map(routed, wave1))
        wall1 = time.perf_counter() - t0
        for st, body, addr in out1:
            used[addr] = used.get(addr, 0) + 1
        if set(used) != set(addrs):
            raise AssertionError(f"load not spread: {used}")
        # a drain and an undrain of replica 1
        router.drain(addrs[1])
        drained = [routed(p)[2] for p in wave1[:4]]
        router.undrain(addrs[1])
        router.scrape_once()
        if set(drained) != {addrs[0]}:
            raise AssertionError(f"drained replica served: {drained}")
        # one replica shut down mid-traffic, as SIGTERM shuts a replica
        # down: the replica the router's cached loads pick next stops
        # admitting, a burst is sent before the next scrape can see it
        # draining (its 503s re-route), its in-flight requests finish,
        # then its listener closes (once the router's cache has it
        # draining, so nothing is sent to a closing socket)
        victim, burst_out = [], []

        def kill():
            deadline = time.monotonic() + 300
            while len(done2) < 4 and time.monotonic() < deadline:
                time.sleep(0.005)
            k = addrs.index(router.pick())
            victim.append(k)
            reps[k][2].drain()
            with ThreadPoolExecutor(ROUTER_BURST) as ex:
                burst_out.extend(ex.map(routed, burst))
            deadline = time.monotonic() + 300
            while not reps[k][2].drained and time.monotonic() < deadline:
                time.sleep(0.01)
            router.scrape_once()
            reps[k][1].shutdown()
            reps[k][1].server_close()

        done2 = []

        def routed2(p):
            out = routed(p)
            done2.append(out)
            return out

        killer = threading.Thread(target=kill)
        killer.start()
        with ThreadPoolExecutor(8) as ex:
            out2 = list(ex.map(routed2, wave2))
        killer.join()
        launches = _kernel_launches()
        per_replica = [r[2].stats["ticks"] - t for r, t in zip(reps, ticks0)]
        retried = retries.total() - r0
        if not victim or len(burst_out) != ROUTER_BURST:
            raise AssertionError("the shutdown did not run")
        outs = out1 + out2 + burst_out
        for st, body, addr in outs:
            if st != 200 or body.get("outcome") != "ok" \
                    or body.get("n_tokens") != ROUTER_TOKENS:
                raise AssertionError(f"routed request: {st} {body}")
        if retried < 1:
            raise AssertionError("no request re-routed after the shutdown")
        if launches["paged_attention"] < sum(per_replica) * L:
            raise AssertionError(f"{launches} launches for "
                                 f"{per_replica} ticks x {L} layers")
        # every answer against a reference scheduler on the same weights
        # (same slots, buckets and kernel; prompts share no prefix block)
        ref_server, ref_sched = serve_decoder(
            reps[1][0], num_slots=SLOTS, paged=True, kv_block=BLOCK,
            queue_size=128)
        ref = _serve_burst(ref_server.server_address[1], prompts,
                           ROUTER_TOKENS, workers=32)
        mism = [i for i, ((_, body, _), (_, rb)) in
                enumerate(zip(outs, ref))
                if body["tokens"] != rb["tokens"]]
        if mism:
            raise AssertionError(f"{len(mism)} routed answers differ from "
                                 f"the reference, first {mism[:5]}")
        # router-added latency: the same small request direct and routed
        live = int(addrs[1 - victim[0]].rsplit(":", 1)[1])
        router.scrape_once()
        direct, via = _latencies((live, rport), [5, 6, 7],
                                 ROUTER_LATENCY_CALLS)
        slo = router.slo.snapshot()
    finally:
        rsrv.shutdown()
        rsrv.server_close()
        router.stop()
        for dec, server, sched, _ in reps:
            server.shutdown()
            server.server_close()
            sched.close()
        if ref_server is not None:
            ref_server.shutdown()
            ref_server.server_close()
            ref_sched.close()
    n_tok = len(wave1) * ROUTER_TOKENS
    out = {"requests": len(prompts), "by_replica_wave1": used,
           "shut_down": addrs[victim[0]],
           "tokens_per_s_wave1": n_tok / wall1, "retries": retried,
           "ticks_by_replica": per_replica,
           "launches_by_replica": [t * L for t in per_replica],
           "direct_p50_ms": float(np.percentile(direct, 50)),
           "direct_p99_ms": float(np.percentile(direct, 99)),
           "routed_p50_ms": float(np.percentile(via, 50)),
           "routed_p99_ms": float(np.percentile(via, 99)),
           "slo_60s": slo["windows"]["60s"], "launches": launches}
    out["router_added_p50_ms"] = out["routed_p50_ms"] - out["direct_p50_ms"]
    out["router_added_p99_ms"] = out["routed_p99_ms"] - out["direct_p99_ms"]
    log(f"[router] {len(prompts)}/{len(prompts)} ok and equal to the "
        f"reference; wave 1 ({len(wave1)} requests) {n_tok / wall1:.1f} "
        f"tok/s spread {used}; replica {victim[0]} shut down mid-wave-2: "
        f"{retried:.0f} re-routes counted; ticks by replica {per_replica} (paged kernel "
        f"launches {[t * L for t in per_replica]}, total "
        f"{launches['paged_attention']}); router-added latency p50 "
        f"{out['router_added_p50_ms']:.2f} ms p99 "
        f"{out['router_added_p99_ms']:.2f} ms (direct p50 "
        f"{out['direct_p50_ms']:.2f} ms); {smi}")
    log(f"[router] {json.dumps(out)}")
    del reps
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------- phase 30
def phase_predict_int8(smi):
    """ResNet-50 inference with int8 weights through the Predictor.
    Returns the main path's launches by kernel."""
    from mxnet_tpu_torch.predict import Predictor

    net, arg, aux = _resnet50()
    x = np.random.default_rng(3).normal(
        size=(PREDICT_BATCH, 3, 224, 224)).astype(np.float32)
    shapes = {"data": (PREDICT_BATCH, 3, 224, 224)}

    def build(**kw):
        return Predictor(symbol=net, arg_params=arg, aux_params=aux,
                         input_shapes=shapes, **kw)

    preds = {"fp32": build(), "bf16": build(dtype="bfloat16"),
             "int8": build(quantize="int8"),
             "int8_env": _with_env({"MXTPU_PREDICT_INT8": "1"}, build)}
    if preds["int8_env"]._quantize != "int8":
        raise AssertionError("MXTPU_PREDICT_INT8=1 did not quantize")
    q = preds["int8"]._qparams
    qbytes = sum(t.q.numel() + 4 * t.scale.numel() for t in q.values())
    fbytes = sum(4 * int(np.prod(preds["fp32"]._params[k].shape))
                 for k in q)
    outs = {}
    for tag, p in preds.items():
        for _ in range(3):                          # warm-up
            p.forward(data=x)
            outs[tag] = p.get_output(0)
    # the kernel against the epilogues pinned to the plain version, both
    # int8 (bit-identical arithmetic in fp32: 1e-6 relative, as in
    # predict_parity)
    pinned = _with_env({"MXTPU_PROGRAM_CACHE": "0"},
                       lambda: build(quantize="int8"))
    for node in pinned._exec._exec_symbol.nodes:
        if node.op == "_residual_epilogue_bn":
            node.attrs["impl"] = "lax"
    pinned.forward(data=x)
    pin_err = _rel_err(torch.from_numpy(outs["int8"]),
                       torch.from_numpy(pinned.get_output(0)))
    del pinned
    if not pin_err <= 1e-6:
        raise AssertionError(f"int8 kernel vs pinned plain: {pin_err}")
    # the main path's run: every kernel count starts at 0 here
    _kernel_launches(reset=True)
    timed = {}
    for tag in ("fp32", "bf16", "int8", "int8_env"):
        p = preds[tag]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PREDICT_CALLS):
            p.forward(data=x)
            out = p.get_output(0)
        timed[tag] = PREDICT_BATCH * PREDICT_CALLS / (time.perf_counter()
                                                      - t0)
        if out.shape != (PREDICT_BATCH, 1000) or not np.isfinite(out).all():
            raise AssertionError(f"{tag}: output {out.shape} not finite")
    launches = _kernel_launches()
    if launches["residual_epilogue"] != 4 * 4 * PREDICT_CALLS:
        raise AssertionError(f"{launches} in {4 * PREDICT_CALLS} forwards; "
                             "want 4 epilogue launches each")
    top1 = float((outs["int8"].argmax(1) == outs["fp32"].argmax(1)).mean())
    env_eq = bool(np.array_equal(outs["int8"], outs["int8_env"]))
    # output_index and partial_forward, once each
    cut = build(quantize="int8", output_index="fc1_output")
    cut.forward(data=x)
    logits = cut.get_output(0)
    e = np.exp(logits - logits.max(1, keepdims=True))
    cut_err = float(np.abs(e / e.sum(1, keepdims=True) - outs["int8"]).max())
    names = preds["fp32"].symbol.get_internals().list_outputs()
    part = preds["int8"].partial_forward(names.index("fc1_output"))[0]
    fp_cut = build(output_index="fc1_output")
    fp_cut.forward(data=x)
    part_err = _rel_err(torch.from_numpy(part),
                        torch.from_numpy(fp_cut.get_output(0)))
    del cut, fp_cut
    # a 4-deep forward_async pipeline against forward
    xs = [np.random.default_rng(30 + i).normal(size=x.shape)
          .astype(np.float32) for i in range(4)]
    p8 = preds["int8"]
    want = []
    for xi in xs:
        p8.forward(data=xi)
        want.append(p8.get_output(0))
    tickets = [p8.forward_async(data=xi) for xi in xs]
    async_err = max(float(np.abs(p8.get_async(t) - w).max())
                    for t, w in zip(tickets, want))
    if not (cut_err <= 1e-5 and part_err <= 1e-4 and async_err <= 1e-5
            and env_eq):
        raise AssertionError(f"output_index {cut_err}, partial_forward "
                             f"{part_err}, forward_async {async_err}, env "
                             f"route equal {env_eq}")
    out = {"imgs_per_s": timed, "top1_agreement_with_fp32": top1,
           "int8_weight_bytes": qbytes, "fp32_weight_bytes": fbytes,
           "kernel_vs_pinned": pin_err, "output_index_err": cut_err,
           "partial_forward_rel_err": part_err,
           "forward_async_err": async_err, "launches": launches}
    log(f"[predict_int8] ResNet-50 b{PREDICT_BATCH} images/s over "
        f"{PREDICT_CALLS} calls: fp32 {timed['fp32']:.2f}, bf16 "
        f"{timed['bf16']:.2f}, int8 {timed['int8']:.2f}, int8 by "
        f"MXTPU_PREDICT_INT8 {timed['int8_env']:.2f}; top-1 agreement with "
        f"fp32 {top1:.4f}; quantized weights {qbytes / 1e6:.2f} MB against "
        f"{fbytes / 1e6:.2f} MB fp32; epilogue kernel vs pinned plain "
        f"{pin_err:.3g} (tol 1e-6), {launches['residual_epilogue']} "
        f"launches; output_index {cut_err:.3g}, partial_forward "
        f"{part_err:.3g}, forward_async x4 {async_err:.3g}; {smi}")
    log(f"[predict_int8] {json.dumps(out)}")
    del preds, p8
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------- phases 31-34
SSD_BATCH = 32
SSD_SIZE = 300
SSD_CLASSES = 20                 # get_symbol_train's default: VOC's 20
SSD_MAX_BOXES = 8
SSD_IMAGES = 64                  # examples/ssd/train.py's synthetic set
SSD_WARMUP = 3
SSD_STEPS = 20
SSD_OPT = {"learning_rate": 1e-3, "momentum": 0.9, "wd": 5e-4}
SSD_ANCHORS = 8732
SSD_SCALE = "relu_conv4_3_scale"  # conv4_3's L2-norm scale, init 20
SSD_DETECT_CALLS = 20
SSD_CPU_IMAGES = 4               # the CPU's share of the end-to-end check
SSD_DETECT_TOL = 1e-5            # card vs CPU scores and boxes, fp32
SSD_RANGES = ("MultiBoxTarget", "MultiBoxDetection.nms")
SSD_KINDS = (        # the first matching kind wins
    ("layout converters", ("nchwToNhwc", "nhwcToNchw")),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit", "xmma",
                     "gemm", "nvjet", "cutlass", "winograd", "fft",
                     "_complex", "DSE::")),
)
# examples/rcnn/rcnn/config.py's sizes; train_end2end.py's batch
RCNN_CFG = {"im_size": 64, "feature_stride": 4, "num_classes": 3,
            "anchor_scales": (2, 4, 8), "anchor_ratios": (0.5, 1, 2),
            "rpn_pre_nms_top_n": 64, "rpn_post_nms_top_n": 16,
            "rpn_nms_thresh": 0.7, "rpn_min_size": 4, "rcnn_batch_rois": 16}
RCNN_BATCH = 8
RCNN_CALLS = 20
RCNN_TOL = (1e-4, 1e-5)          # card vs CPU, relative and absolute
RCNN_ROI_TOL = 1e-3              # RoI corners in pixels of a 64 image
# examples/warpctc/lstm_ocr.py's defaults
OCR_H, OCR_W, OCR_DIGITS = 16, 48, 5
OCR_BATCH = 32
OCR_HIDDEN = 48
OCR_CLASSES = 11                 # blank + 10 digits
OCR_LR = 4e-3
OCR_STEPS = 200
# the first step, card vs CPU: relative, and absolute as a share of
# each tensor's largest entry (a gradient sums 48 steps x 32 sequences)
OCR_TOL = (1e-4, 1e-6)
OCR_SEGMENTS = {
    0: (1, 1, 1, 0, 1, 1, 1), 1: (0, 0, 1, 0, 0, 1, 0),
    2: (1, 0, 1, 1, 1, 0, 1), 3: (1, 0, 1, 1, 0, 1, 1),
    4: (0, 1, 1, 1, 0, 1, 0), 5: (1, 1, 0, 1, 0, 1, 1),
    6: (1, 1, 0, 1, 1, 1, 1), 7: (1, 0, 1, 0, 0, 1, 0),
    8: (1, 1, 1, 1, 1, 1, 1), 9: (1, 1, 1, 1, 0, 1, 1),
}


def synthetic_detections(num, size, max_boxes, num_classes, seed=5):
    """examples/ssd/train.py's data: images with coloured rectangles,
    labels (num, max_boxes, 5) [cls, x1, y1, x2, y2] normalized, -1
    padded."""
    rs = np.random.RandomState(seed)
    imgs = np.zeros((num, 3, size, size), np.float32)
    labels = np.full((num, max_boxes, 5), -1.0, np.float32)
    for i in range(num):
        nbox = rs.randint(1, max_boxes + 1)
        for j in range(nbox):
            cls = rs.randint(0, num_classes)
            w, h = rs.uniform(0.2, 0.5, 2)
            x1, y1 = rs.uniform(0, 1 - w), rs.uniform(0, 1 - h)
            x2, y2 = x1 + w, y1 + h
            px = (np.array([x1, y1, x2, y2]) * size).astype(int)
            imgs[i, cls % 3, px[1]:px[3], px[0]:px[2]] = 1.0
            labels[i, j] = [cls, x1, y1, x2, y2]
    return imgs, labels


def _box_iou(box, boxes):
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    area = (box[2] - box[0]) * (box[3] - box[1])
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = area + areas - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def map_metrics():
    """``(MApMetric(), VOC07MApMetric())``: examples/ssd/eval_metric.py's
    two metrics over the port's ``EvalMetric`` (the example imports the
    JAX package's).  ``update(labels, preds)``: preds (batch, num_det, 6)
    [cls, score, x1, y1, x2, y2], labels (batch, num_gt, 5), cls < 0
    padding; per-class ranked matching at IoU 0.5, AP by the continuous
    precision envelope or VOC-2007's 11 points."""
    from mxnet_tpu_torch.metric import EvalMetric

    class MApMetric(EvalMetric):
        def __init__(self, iou_thresh=0.5, name="mAP"):
            self.iou_thresh = iou_thresh
            super().__init__(name)

        def reset(self):
            self._records, self._gt_counts = [], {}
            super().reset()

        def update(self, labels, preds):
            for lab, pred in zip(labels, preds):
                for b in range(lab.shape[0]):
                    self._update_one(np.asarray(lab[b]), np.asarray(pred[b]))

        def _update_one(self, gts, dets):
            gts = gts[gts[:, 0] >= 0]
            dets = dets[dets[:, 0] >= 0]
            for c in np.unique(gts[:, 0]).astype(int):
                self._gt_counts[c] = (self._gt_counts.get(c, 0)
                                      + int((gts[:, 0] == c).sum()))
            order = np.argsort(-dets[:, 1]) if len(dets) else []
            taken = np.zeros(len(gts), bool)
            for di in order:
                d = dets[di]
                c = int(d[0])
                cand = np.where(gts[:, 0] == c)[0]
                matched = False
                if len(cand):
                    ious = _box_iou(d[2:6], gts[cand, 1:5])
                    best = int(np.argmax(ious))
                    # VOC: the best gt only; taken already = false positive
                    if ious[best] >= self.iou_thresh and not taken[cand[best]]:
                        taken[cand[best]] = matched = True
                self._records.append((c, float(d[1]), matched))

        def _average_precision(self, rec, prec):
            mrec = np.concatenate([[0.0], rec, [1.0]])
            mpre = np.concatenate([[0.0], prec, [0.0]])
            for i in range(len(mpre) - 2, -1, -1):
                mpre[i] = max(mpre[i], mpre[i + 1])
            idx = np.where(mrec[1:] != mrec[:-1])[0]
            return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))

        def get(self):
            aps = []
            for c, n_gt in sorted(self._gt_counts.items()):
                recs = sorted((r for r in self._records if r[0] == c),
                              key=lambda r: -r[1])
                tp = np.cumsum([1.0 if m else 0.0 for _, _, m in recs])
                fp = np.cumsum([0.0 if m else 1.0 for _, _, m in recs])
                rec = tp / n_gt if len(recs) else np.array([0.0])
                prec = (tp / np.maximum(tp + fp, 1e-12) if len(recs)
                        else np.array([0.0]))
                aps.append(self._average_precision(rec, prec))
            return self.name, float(np.mean(aps)) if aps else float("nan")

    class VOC07MApMetric(MApMetric):
        def __init__(self, iou_thresh=0.5, name="VOC07_mAP"):
            super().__init__(iou_thresh, name)

        def _average_precision(self, rec, prec):
            ap = 0.0
            for t in np.linspace(0, 1, 11):
                mask = rec >= t
                ap += (float(np.max(prec[mask])) if mask.any() else 0.0) / 11
            return ap

    return MApMetric(), VOC07MApMetric()


def rcnn_symbol(cfg, batch, train_rois=False):
    """examples/rcnn/rcnn/symbols.py's ``get_symbol`` over the port's
    ``sym``: the 3-conv backbone, the RPN heads, ``Proposal`` (or a
    ``rois`` input under ``train_rois``), ``ROIPooling`` and the
    fast-rcnn head.  Outputs [rpn_cls_prob, rpn_bbox_loss, cls_prob,
    bbox_loss (train) | bbox_pred (eval), rois]."""
    from mxnet_tpu_torch import symbol as sym

    a0 = len(cfg["anchor_scales"]) * len(cfg["anchor_ratios"])
    f = cfg["im_size"] // cfg["feature_stride"]
    classes = cfg["num_classes"]
    data = sym.Variable("data")
    im_info = sym.Variable("im_info")
    rpn_label = sym.Variable("rpn_label")
    rpn_bbox_target = sym.Variable("rpn_bbox_target")
    rpn_bbox_weight = sym.Variable("rpn_bbox_weight")
    roi_label = sym.Variable("roi_label")

    net = sym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=16,
                          name="conv1")
    net = sym.Activation(net, act_type="relu")
    net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = sym.Convolution(net, kernel=(3, 3), pad=(1, 1), num_filter=32,
                          name="conv2")
    net = sym.Activation(net, act_type="relu")
    net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = sym.Convolution(net, kernel=(3, 3), pad=(1, 1), num_filter=32,
                          name="conv3")
    feat = sym.Activation(net, act_type="relu", name="feat")

    rpn = sym.Convolution(feat, kernel=(3, 3), pad=(1, 1), num_filter=32,
                          name="rpn_conv")
    rpn = sym.Activation(rpn, act_type="relu")
    rpn_cls = sym.Convolution(rpn, kernel=(1, 1), num_filter=2 * a0,
                              name="rpn_cls_score")
    rpn_bbox = sym.Convolution(rpn, kernel=(1, 1), num_filter=4 * a0,
                               name="rpn_bbox_pred")
    rpn_cls_flat = sym.Reshape(rpn_cls, shape=(0, 2, -1),
                               name="rpn_cls_flat")
    rpn_cls_prob = sym.SoftmaxOutput(rpn_cls_flat, rpn_label,
                                     multi_output=True, use_ignore=True,
                                     ignore_label=-1,
                                     normalization="valid",
                                     name="rpn_cls_prob")
    rpn_bbox_loss = sym.smooth_l1(
        rpn_bbox_weight * (rpn_bbox - rpn_bbox_target), scalar=3.0)
    rpn_bbox_loss = sym.MakeLoss(sym.sum(rpn_bbox_loss) / batch,
                                 name="rpn_bbox_loss")
    rpn_cls_act = sym.SoftmaxActivation(rpn_cls_flat, mode="channel",
                                        name="rpn_cls_act")
    rpn_cls_act = sym.Reshape(rpn_cls_act, shape=(0, 2 * a0, f, f))
    if train_rois:
        rois = sym.BlockGrad(sym.Variable("rois"), name="rois")
    else:
        rois = sym.Proposal(
            sym.BlockGrad(rpn_cls_act), sym.BlockGrad(rpn_bbox), im_info,
            feature_stride=cfg["feature_stride"],
            scales=cfg["anchor_scales"], ratios=cfg["anchor_ratios"],
            rpn_pre_nms_top_n=cfg["rpn_pre_nms_top_n"],
            rpn_post_nms_top_n=cfg["rpn_post_nms_top_n"],
            threshold=cfg["rpn_nms_thresh"], rpn_min_size=cfg["rpn_min_size"],
            name="rois")
    pooled = sym.ROIPooling(feat, rois, pooled_size=(4, 4),
                            spatial_scale=1.0 / cfg["feature_stride"],
                            name="roi_pool")
    head = sym.FullyConnected(sym.Flatten(pooled), num_hidden=64,
                              name="fc6")
    head = sym.Activation(head, act_type="relu")
    cls_score = sym.FullyConnected(head, num_hidden=classes,
                                   name="cls_score")
    cls_prob = sym.SoftmaxOutput(cls_score, roi_label, use_ignore=True,
                                 ignore_label=-1, normalization="valid",
                                 name="cls_prob")
    bbox_pred = sym.FullyConnected(head, num_hidden=4 * classes,
                                   name="bbox_pred")
    if train_rois:
        bbox_target = sym.Variable("bbox_target")
        bbox_weight = sym.Variable("bbox_weight")
        n_rois = batch * cfg["rcnn_batch_rois"]
        bbox_loss = sym.smooth_l1(
            bbox_weight * (bbox_pred - bbox_target), scalar=1.0)
        bbox_branch = sym.MakeLoss(sym.sum(bbox_loss) / n_rois,
                                   name="bbox_loss")
    else:
        bbox_branch = sym.BlockGrad(bbox_pred, name="bbox_pred_out")
    return sym.Group([rpn_cls_prob, rpn_bbox_loss, cls_prob, bbox_branch,
                      sym.BlockGrad(rois)])


def rcnn_shapes(cfg, batch, train_rois):
    """The input shapes of :func:`rcnn_symbol` (train_utils.py's bind)."""
    a0 = len(cfg["anchor_scales"]) * len(cfg["anchor_ratios"])
    f = cfg["im_size"] // cfg["feature_stride"]
    r = batch * (cfg["rcnn_batch_rois"] if train_rois
                 else cfg["rpn_post_nms_top_n"])
    shapes = {"data": (batch, 3, cfg["im_size"], cfg["im_size"]),
              "im_info": (batch, 3), "rpn_label": (batch, a0 * f * f),
              "rpn_bbox_target": (batch, 4 * a0, f, f),
              "rpn_bbox_weight": (batch, 4 * a0, f, f), "roi_label": (r,)}
    if train_rois:
        shapes.update(rois=(r, 5), bbox_target=(r, 4 * cfg["num_classes"]),
                      bbox_weight=(r, 4 * cfg["num_classes"]))
        del shapes["im_info"]
    return shapes


def _draw_digit(digit, height, width):
    img = np.zeros((height, width), np.float32)
    t, tl, tr, m, bl, br, b = OCR_SEGMENTS[digit]
    mid = height // 2
    if t:
        img[0:2, 1:width - 1] = 1
    if m:
        img[mid - 1:mid + 1, 1:width - 1] = 1
    if b:
        img[height - 2:height, 1:width - 1] = 1
    if tl:
        img[0:mid, 0:2] = 1
    if tr:
        img[0:mid, width - 2:width] = 1
    if bl:
        img[mid:height, 0:2] = 1
    if br:
        img[mid:height, width - 2:width] = 1
    return img


def gen_captcha(rs):
    """examples/warpctc/lstm_ocr.py's seven-segment captcha: (image (H,
    W), label (MAX_DIGITS,) 0-padded with digits as 1..10)."""
    n = int(rs.randint(3, OCR_DIGITS + 1))
    want = [int(rs.randint(0, 10)) for _ in range(n)]
    img = np.zeros((OCR_H, OCR_W), np.float32)
    x = int(rs.randint(0, 4))
    drawn = []
    for d in want:
        w = int(rs.randint(6, 9))
        if x + w > OCR_W:
            break
        y0 = int(rs.randint(0, 3))
        img[y0:y0 + 12, x:x + w] = np.maximum(
            img[y0:y0 + 12, x:x + w], _draw_digit(d, 12, w))
        drawn.append(d)
        x += w + int(rs.randint(1, 4))
    img = np.clip(img + rs.normal(0, 0.08, img.shape), 0, 1)
    label = np.zeros((OCR_DIGITS,), np.float32)
    for i, d in enumerate(drawn):
        label[i] = d + 1
    return img.astype(np.float32), label


def ocr_batches(rs, n, batch):
    """``n`` batches of :func:`gen_captcha` in the example's draw order:
    images (n, batch, H, W), labels (n, batch, MAX_DIGITS)."""
    out = [gen_captcha(rs) for _ in range(n * batch)]
    imgs = np.stack([o[0] for o in out]).reshape(n, batch, OCR_H, OCR_W)
    labels = np.stack([o[1] for o in out]).reshape(n, batch, OCR_DIGITS)
    return imgs, labels


def ocr_net(num_hidden, num_classes):
    """lstm_ocr.py's ``build_net`` over the port: image columns through
    ``LSTMCell`` unrolled over W, a per-step FC, ``WarpCTC`` over (T, N,
    C) with label_length 5 and input_length W."""
    from mxnet_tpu_torch import rnn
    from mxnet_tpu_torch import symbol as sym

    data = sym.Variable("data")
    cols = sym.transpose(data, axes=(0, 2, 1))
    stack = rnn.SequentialRNNCell()
    stack.add(rnn.LSTMCell(num_hidden, prefix="l0_"))
    outputs, _ = stack.unroll(OCR_W, inputs=cols, layout="NTC",
                              merge_outputs=True)
    feat = sym.Reshape(outputs, shape=(-1, num_hidden))
    fc = sym.FullyConnected(feat, num_hidden=num_classes, name="pred_fc")
    pred = sym.Reshape(fc, shape=(-1, OCR_W, num_classes))
    pred = sym.transpose(pred, axes=(1, 0, 2))
    label = sym.Variable("label")
    return sym.WarpCTC(pred, label, label_length=OCR_DIGITS,
                       input_length=OCR_W, name="ctc")


def seq_accuracy(probs_tnc, labels):
    """Greedy CTC decode of probs (T, N, C) (collapse repeats, drop
    blanks) against 0-padded labels: the share of exact sequences."""
    correct = 0
    for row, lab in zip(probs_tnc.argmax(axis=2).T, labels):
        out, prev = [], None
        for p in row:
            if p != prev and p != 0:
                out.append(int(p))
            prev = p
        correct += out == [int(v) for v in lab if v > 0]
    return correct / len(labels)


def _range_profile(run, steps, ranges, kinds):
    """Over ``run()`` (``steps`` steps) under torch.profiler: device ms
    per step of the kernels that start inside each named range's span on
    the device, of the others by kind of kernel name ("rest" for none),
    busy ms, host launch calls per step in all and inside each range's
    span on the host, and each range's host ms per step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = {r: [] for r in ranges}
    host = {r: [] for r in ranges}
    kernels, launches = [], []
    for ev in prof.events():
        span = (ev.time_range.start, ev.time_range.end)
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if ev.name in dev:
                dev[ev.name].append(span)
            else:
                kernels.append((span, ev.name))
        elif ev.name in host:
            host[ev.name].append(span)
        elif ev.name in LAUNCH_CALLS:
            launches.append(span[0])
    by = dict.fromkeys(list(ranges) + [k for k, _ in kinds] + ["rest"], 0.0)
    top = {}
    for (t0, t1), name in kernels:
        ms = (t1 - t0) / 1e3 / steps
        key = next((r for r in ranges
                    if any(a <= t0 < b for a, b in dev[r])), None) \
            or next((k for k, pats in kinds
                     if any(p in name for p in pats)), "rest")
        by[key] += ms
        top[name] = top.get(name, 0.0) + ms
    return {"by_kind_ms": by, "busy_ms": sum(by.values()),
            "kernels_per_step": len(kernels) / steps,
            "launch_calls_per_step": len(launches) / steps,
            "range_launch_calls_per_step": {
                r: sum(any(a <= t < b for a, b in host[r])
                       for t in launches) / steps for r in ranges},
            "range_host_ms": {r: sum(b - a for a, b in host[r]) / 1e3 / steps
                              for r in ranges},
            "top": sorted(((t, n) for n, t in top.items()), reverse=True)[:6]}


def _profile_line(tag, prof, wall_ms, unit="step"):
    return (f"[{tag}-profile] per {unit}: {wall_ms:.3f} ms wall, device "
            f"busy {prof['busy_ms']:.3f} ms, idle share "
            f"{1 - prof['busy_ms'] / wall_ms:.4f}; host launch calls "
            f"{prof['launch_calls_per_step']:.1f}, kernels "
            f"{prof['kernels_per_step']:.1f}; by kind: "
            + ", ".join(f"{k} {t:.3f}" for k, t in prof["by_kind_ms"].items())
            + "; ranges (host ms, host launch calls): "
            + ", ".join(f"{r} {prof['range_host_ms'][r]:.3f} / "
                        f"{c:.1f}" for r, c in
                        prof["range_launch_calls_per_step"].items())
            + "; top: " + "; ".join(f"{n[:70]} {t:.3f}"
                                    for t, n in prof["top"]))


def _xavier_args(net, ex, skip, seed):
    """examples/ssd/train.py's init: Xavier on every argument but
    ``skip``, from a seeded generator on the card, except a variable's
    own ``__init__`` attr (SSD's conv4_3 scale: 20), which the port
    honours as ``Module.init_params`` does (the example's loop, which
    calls Xavier by name, leaves that scale at 0 in the JAX package)."""
    from mxnet_tpu_torch import initializer

    xavier = initializer.Xavier(
        generator=torch.Generator(device=CARD).manual_seed(seed))
    own = initializer.variable_initializers(net)
    for name, arr in ex.arg_dict.items():
        if not skip(name):
            own.get(name, xavier)(name, arr)
    return sorted(own)


def _ssd_losses(outs):
    """The step's class cross-entropy over the targets that count
    (cls_label >= 0) and smooth-L1 loc loss per positive anchor, on the
    card (nothing read)."""
    cls_prob, loc_loss, cls_label = outs[0], outs[1], outs[2]
    valid = cls_label >= 0
    p = cls_prob.gather(1, cls_label.clamp(min=0).long()[:, None])[:, 0]
    ce = -(torch.log(p.clamp(min=1e-30)) * valid).sum() \
        / valid.sum().clamp(min=1)
    return torch.stack([ce, loc_loss.sum()
                        / (cls_label > 0).sum().clamp(min=1)])


def phase_ssd_train(smi):
    """examples/ssd/train.py's executor loop at full width: SSD-VGG16-300
    (20 classes) at batch 32 x 3 x 300 x 300, fp32, Xavier, SGD lr 1e-3
    momentum 0.9 wd 5e-4 through ``optimizer.get_updater``, over the
    example's 64 synthetic images on the card."""
    from mxnet_tpu_torch import optimizer
    from mxnet_tpu_torch.models import ssd

    b = SSD_BATCH
    net = ssd.get_symbol_train(num_classes=SSD_CLASSES)
    shapes = {"data": (b, 3, SSD_SIZE, SSD_SIZE),
              "label": (b, SSD_MAX_BOXES, 5)}
    _, out_shapes, _ = net.infer_shape(**shapes)
    anchors = out_shapes[3][1]
    if anchors != SSD_ANCHORS or out_shapes[0] != (b, SSD_CLASSES + 1,
                                                   SSD_ANCHORS):
        raise AssertionError(f"ssd_train: output shapes {out_shapes}, want "
                             f"{SSD_ANCHORS} anchors")
    flops = _graph_flops(ssd.get_symbol(num_classes=SSD_CLASSES),
                         (1, 3, SSD_SIZE, SSD_SIZE))
    ex = net.simple_bind(CARD, **shapes)
    own = _xavier_args(net, ex, lambda n: n in ("data", "label"), seed=17)
    scale = float(ex.arg_dict[SSD_SCALE].mean())
    imgs, labels = synthetic_detections(SSD_IMAGES, SSD_SIZE, SSD_MAX_BOXES,
                                        SSD_CLASSES)
    imgs = torch.from_numpy(imgs).to(CARD)
    labels = torch.from_numpy(labels).to(CARD)
    opt = optimizer.create("sgd", **SSD_OPT)
    updater = optimizer.get_updater(opt)
    names = net.list_arguments()
    losses = []

    def step(i):
        sel = slice((i * b) % SSD_IMAGES, (i * b) % SSD_IMAGES + b)
        ex.arg_dict["data"].copy_(imgs[sel])
        ex.arg_dict["label"].copy_(labels[sel])
        ex.forward(is_train=True)
        ex.backward()
        for k, name in enumerate(names):
            if name in ("data", "label") or ex.grad_dict.get(name) is None:
                continue
            updater(k, ex.grad_dict[name], ex.arg_dict[name])
        losses.append(_ssd_losses(ex.outputs))

    t0 = time.perf_counter()
    for i in range(SSD_WARMUP):
        step(i)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    with _SyncCounter() as sc:
        t0 = time.perf_counter()
        for i in range(SSD_WARMUP, SSD_WARMUP + SSD_STEPS):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        syncs = sc.total()
    peak = torch.cuda.max_memory_allocated()
    step_ms = wall / SSD_STEPS * 1e3
    img_s = b * SSD_STEPS / wall
    n = SSD_WARMUP + SSD_STEPS
    prof = _range_profile(lambda: [step(n + i) for i in range(2)], 2,
                          SSD_RANGES, SSD_KINDS)
    curve = torch.stack(losses).cpu().numpy()
    first, last = curve[:3].mean(axis=0), curve[-3:].mean(axis=0)
    nms_calls = prof["range_launch_calls_per_step"]["MultiBoxDetection.nms"]
    out = {"img_s": img_s, "step_ms": step_ms, "warmup_s": warm_s,
           "anchors": anchors, "gflop_per_img_fwd": flops / 1e9,
           "mfu_fp32": 3 * flops * img_s / PEAK_FLOPS[torch.float32],
           "host_syncs_per_step": syncs / SSD_STEPS,
           "peak_gib": peak / 2**30, "busy_ms": prof["busy_ms"],
           "idle_share": 1 - prof["busy_ms"] / step_ms,
           "device_ms_by_kind": prof["by_kind_ms"],
           "launch_calls_per_step": prof["launch_calls_per_step"],
           "nms_launch_calls_per_step": nms_calls,
           "nms_host_ms_per_step": prof["range_host_ms"][
               "MultiBoxDetection.nms"],
           "cls_ce_first_last": [float(first[0]), float(last[0])],
           "loc_loss_first_last": [float(first[1]), float(last[1])],
           "conv4_3_scale_init": scale, "own_init": own}
    log(_profile_line("ssd_train", prof, step_ms))
    log(f"[ssd_train] SSD-VGG16-300, {SSD_CLASSES} classes, b{b} fp32: "
        f"{img_s:.2f} img/s, {step_ms:.3f} ms a step ({SSD_STEPS} steps; "
        f"{SSD_WARMUP} warm-up steps {warm_s:.2f} s), {anchors} anchors, "
        f"{flops / 1e9:.2f} GFLOP a forward image, MFU "
        f"{out['mfu_fp32']:.4f} of fp32 67 TFLOP/s; busy "
        f"{prof['busy_ms']:.3f} ms, idle {out['idle_share']:.4f}; "
        f"{prof['launch_calls_per_step']:.1f} launch calls a step, "
        f"{nms_calls:.1f} in the NMS loop; host syncs a step "
        f"{out['host_syncs_per_step']:.2f}; peak {out['peak_gib']:.2f} GiB; "
        f"class CE {first[0]:.4f} -> {last[0]:.4f}, loc loss "
        f"{first[1]:.4f} -> {last[1]:.4f}; own init {own} ({scale:.1f} "
        f"after init); {smi}")
    log(f"[ssd_train] {json.dumps(out)}")
    if syncs:
        raise AssertionError(f"ssd_train: {syncs} host syncs in "
                             f"{SSD_STEPS} steps")
    if not last[0] < first[0]:
        raise AssertionError(f"ssd_train: the class loss did not fall: "
                             f"{curve[:, 0].tolist()}")
    if scale != 20.0 or own != [SSD_SCALE]:
        raise AssertionError(f"ssd_train: {SSD_SCALE} {scale} after init, "
                             f"own inits {own}")
    params = {k: v.detach().clone() for k, v in ex.arg_dict.items()
              if k not in ("data", "label")}
    del ex, updater, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out, params, (imgs, labels)


def _detections_agree(card, cpu, tol):
    """Card and CPU detections (n, A, 6) of the same weights and inputs:
    class ids, kept rows and scores/boxes within ``tol`` wherever the
    CPU's score is not within ``tol`` of a neighbour's (there, the order
    of equal scores decides); the sorted scores within ``tol``
    throughout.  Returns (rows compared, tie rows, worst error)."""
    rows = ties = 0
    worst = 0.0
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(np.sort(a[:, 1]), np.sort(b[:, 1]),
                                   rtol=0, atol=tol)
        s = b[:, 1]
        gap = np.abs(np.diff(s))
        tie = np.zeros(len(s), bool)
        tie[:-1] |= gap <= tol
        tie[1:] |= gap <= tol
        tie &= s > 0
        keep = ~tie
        np.testing.assert_array_equal(a[keep, 0], b[keep, 0])
        np.testing.assert_allclose(a[keep, 1:], b[keep, 1:], rtol=0,
                                   atol=tol)
        worst = max(worst, float(np.abs(a[keep, 1:] - b[keep, 1:]).max(
            initial=0.0)))
        rows += int(keep.sum())
        ties += int(tie.sum())
    return rows, ties, worst


def phase_ssd_detect(smi, params, data):
    """SSD's deploy graph (softmax + ``MultiBoxDetection``, nms_topk 400)
    through the ``Predictor`` at batch 32 x 300 x 300 with the trained
    weights: images/s, the NMS loop's share of a forward, the detections
    against the port's CPU run, the op alone on the card against the CPU
    on the same inputs, and VOC mAP over the 64 images."""
    from mxnet_tpu_torch.models import ssd
    from mxnet_tpu_torch.ops import registry as treg
    from mxnet_tpu_torch.predict import Predictor
    from mxnet_tpu_torch.symbol import Symbol

    imgs, labels = data
    b = SSD_BATCH
    deploy = ssd.get_symbol(num_classes=SSD_CLASSES)
    p = Predictor(symbol=deploy, arg_params=params, aux_params={},
                  input_shapes={"data": (b, 3, SSD_SIZE, SSD_SIZE)})
    x = imgs[:b]
    for _ in range(2):
        p.forward(data=x)
        p.get_output(0)
    t0 = time.perf_counter()
    for _ in range(SSD_DETECT_CALLS):
        p.forward(data=x)
        det = p.get_output(0)
    fwd_ms = (time.perf_counter() - t0) / SSD_DETECT_CALLS * 1e3
    img_s = b / fwd_ms * 1e3

    def calls():
        for _ in range(3):
            p.forward(data=x)
            p.get_output(0)

    prof = _range_profile(calls, 3, ("MultiBoxDetection.nms",), SSD_KINDS)
    nms_ms = prof["by_kind_ms"]["MultiBoxDetection.nms"]
    nms_host = prof["range_host_ms"]["MultiBoxDetection.nms"]
    nms_calls = prof["range_launch_calls_per_step"]["MultiBoxDetection.nms"]
    log(_profile_line("ssd_detect", prof, fwd_ms, unit="forward"))

    # the end-to-end check: the port on the CPU, same weights and images
    cpu = Predictor(symbol=deploy,
                    arg_params={k: v.cpu() for k, v in params.items()},
                    aux_params={}, dev_type="cpu",
                    input_shapes={"data": (SSD_CPU_IMAGES, 3, SSD_SIZE,
                                           SSD_SIZE)})
    cpu.forward(data=x[:SSD_CPU_IMAGES].cpu())
    rows, ties, worst = _detections_agree(det[:SSD_CPU_IMAGES],
                                          cpu.get_output(0), SSD_DETECT_TOL)
    del cpu

    # the op alone: the card's MultiBoxDetection against the CPU's on the
    # card's own inputs (the graph's softmax, loc predictions, anchors)
    node = next(nd for nd in deploy.nodes if nd.op == "MultiBoxDetection")
    feed = Predictor(symbol=Symbol(list(node.inputs)), arg_params=params,
                     aux_params={},
                     input_shapes={"data": (b, 3, SSD_SIZE, SSD_SIZE)})
    feed.forward(data=x)
    ins = [torch.from_numpy(feed.get_output(i)).to(CARD) for i in range(3)]
    op = treg.get("MultiBoxDetection")
    on_card = op.fn(None, *ins, **node.attrs).cpu().numpy()
    on_cpu = op.fn(None, *[t.cpu() for t in ins], **node.attrs).numpy()
    # the op alone, unprofiled: host ms to enqueue a call, and ms a call
    # to the device's end
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SSD_DETECT_CALLS):
        op.fn(None, *ins, **node.attrs)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    op_host_ms = (t1 - t0) / SSD_DETECT_CALLS * 1e3
    op_ms = (t2 - t0) / SSD_DETECT_CALLS * 1e3
    np.testing.assert_array_equal(on_card[..., 0], on_cpu[..., 0])
    op_err = float(np.abs(on_card - on_cpu).max())
    if op_err > 1e-6:
        raise AssertionError(f"ssd_detect: the op on the card differs from "
                             f"the CPU's by {op_err}")
    del feed

    m, m07 = map_metrics()
    for i in range(0, SSD_IMAGES, b):
        p.forward(data=imgs[i:i + b])
        d = p.get_output(0)
        lab = labels[i:i + b].cpu().numpy()
        m.update([lab], [d])
        m07.update([lab], [d])
    kept = int((det[..., 0] >= 0).sum())
    out = {"img_s": img_s, "forward_ms": fwd_ms, "busy_ms": prof["busy_ms"],
           "idle_share": 1 - prof["busy_ms"] / fwd_ms,
           "nms_device_ms": nms_ms,
           "nms_device_share": nms_ms / max(prof["busy_ms"], 1e-9),
           "nms_host_ms": nms_host,
           "nms_wall_share": nms_host / fwd_ms,
           "nms_launch_calls": nms_calls,
           "launch_calls_per_forward": prof["launch_calls_per_step"],
           "kept_per_image": kept / b, "cpu_rows_equal": rows,
           "cpu_tie_rows": ties, "cpu_worst_err": worst,
           "op_card_vs_cpu_err": op_err, "op_alone_host_ms": op_host_ms,
           "op_alone_ms": op_ms, "mAP": m.get()[1],
           "VOC07_mAP": m07.get()[1]}
    log(f"[ssd_detect] deploy graph b{b} through the Predictor: {img_s:.2f} "
        f"img/s ({fwd_ms:.3f} ms a forward + copy-out, {SSD_DETECT_CALLS} "
        f"calls); the NMS loop {nms_calls:.0f} launch calls, host "
        f"{nms_host:.3f} ms ({out['nms_wall_share']:.3f} of the wall), "
        f"device {nms_ms:.3f} ms ({out['nms_device_share']:.3f} of busy "
        f"{prof['busy_ms']:.3f}); MultiBoxDetection alone (unprofiled) "
        f"{op_host_ms:.3f} host ms to enqueue, {op_ms:.3f} ms to the "
        f"device's end; {kept / b:.1f} kept rows an image; CPU "
        f"run of {SSD_CPU_IMAGES} images: {rows} rows equal (worst "
        f"{worst:.3g} <= {SSD_DETECT_TOL}), {ties} rows in score ties "
        f"within {SSD_DETECT_TOL}; the op alone card vs CPU {op_err:.3g}; "
        f"mAP {out['mAP']:.4f}, VOC07 mAP {out['VOC07_mAP']:.4f}; {smi}")
    log(f"[ssd_detect] {json.dumps(out)}")
    del p
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _match_rows(a, b, tol):
    """The permutation of ``b``'s rows that puts each next to its equal
    in ``a`` (L-inf within ``tol``): the order of two proposals with
    scores within rounding may differ between the card and the CPU."""
    perm = []
    for row in a:
        d = np.abs(b - row).max(axis=1)
        j = int(np.argmin(d))
        if d[j] > tol:
            raise AssertionError(f"no row of the CPU's within {tol} of "
                                 f"{row}: nearest {b[j]}")
        perm.append(j)
    return np.array(perm)


def _rcnn_inputs(cfg, batch, seed):
    """Seeded inputs of both graphs: examples/ssd/train.py's rectangles
    at the rcnn image size, RPN targets and head targets."""
    a0 = len(cfg["anchor_scales"]) * len(cfg["anchor_ratios"])
    f = cfg["im_size"] // cfg["feature_stride"]
    rs = np.random.RandomState(seed)
    imgs, _ = synthetic_detections(batch, cfg["im_size"], 4,
                                   cfg["num_classes"] - 1, seed=seed)
    r = batch * cfg["rcnn_batch_rois"]
    c4 = 4 * cfg["num_classes"]
    return {
        "data": imgs,
        "im_info": np.tile(np.array([[cfg["im_size"], cfg["im_size"], 1.0]],
                                    np.float32), (batch, 1)),
        "rpn_label": rs.randint(-1, 2, (batch, a0 * f * f)).astype(
            np.float32),
        "rpn_bbox_target": rs.normal(0, 0.5, (batch, 4 * a0, f, f)).astype(
            np.float32),
        "rpn_bbox_weight": (rs.uniform(size=(batch, 4 * a0, f, f))
                            < 0.2).astype(np.float32),
        "roi_label": rs.randint(0, cfg["num_classes"], (r,)).astype(
            np.float32),
        "bbox_target": rs.normal(0, 0.5, (r, c4)).astype(np.float32),
        "bbox_weight": (rs.uniform(size=(r, c4)) < 0.3).astype(np.float32),
    }


def _bind_rcnn(net, shapes, params, values, device):
    ex = net.simple_bind(device, **shapes)
    ex.copy_params_from({k: v for k, v in params.items()
                         if k in ex.arg_dict})
    for k in shapes:
        ex.arg_dict[k].copy_(torch.from_numpy(values[k]))
    return ex


def phase_rcnn(smi):
    """Faster R-CNN at examples/rcnn/rcnn/config.py's sizes (image 64,
    stride 4, 3 classes, pre-NMS 64, post-NMS 16, 16 RoIs an image),
    batch 8: the eval graph's forward (RPN -> ``Proposal`` ->
    ``ROIPooling`` -> head) and a ``train_rois=True`` step (forward,
    backward through ``ROIPooling``, SGD), each against the port on the
    CPU from the same weights and inputs, then timed."""
    from mxnet_tpu_torch import optimizer

    cfg, b = RCNN_CFG, RCNN_BATCH
    eval_net = rcnn_symbol(cfg, b, train_rois=False)
    train_net = rcnn_symbol(cfg, b, train_rois=True)
    eval_shapes = rcnn_shapes(cfg, b, False)
    train_shapes = rcnn_shapes(cfg, b, True)
    values = _rcnn_inputs(cfg, b, seed=8)
    ex = train_net.simple_bind(CARD, **train_shapes)
    _xavier_args(train_net, ex, lambda n: not n.endswith(("weight", "bias")),
                 seed=18)
    params = {k: v.detach().clone() for k, v in ex.arg_dict.items()
              if k.endswith(("weight", "bias"))}
    del ex
    rtol, atol = RCNN_TOL

    # the eval forward, card against CPU
    outs = {}
    for dev in (CARD, "cpu"):
        ex = _bind_rcnn(eval_net, eval_shapes, params, values, dev)
        outs[dev] = [o.detach().cpu().numpy()
                     for o in ex.forward(is_train=False)]
        if dev == CARD:
            eval_ex = ex
    card, cpu = outs[CARD], outs["cpu"]
    post = cfg["rpn_post_nms_top_n"]
    perm = np.concatenate([
        i * post + _match_rows(card[4][i * post:(i + 1) * post],
                               cpu[4][i * post:(i + 1) * post], RCNN_ROI_TOL)
        for i in range(b)])
    eval_err = {}
    for k, (c, h) in enumerate(zip(card, cpu)):
        if k >= 2:  # the head's rows follow the RoIs
            h = h[perm]
        np.testing.assert_allclose(c, h, rtol=rtol,
                                   atol=RCNN_ROI_TOL if k == 4 else atol)
        eval_err[k] = float(np.abs(c - h).max())
    reordered = int((perm != np.arange(len(perm))).sum())
    values["rois"] = card[4]

    # the train step's forward and backward, card against CPU
    grads = {}
    for dev in (CARD, "cpu"):
        ex = _bind_rcnn(train_net, train_shapes, params, values, dev)
        o = ex.forward(is_train=True)
        ex.backward()
        grads[dev] = ([t.detach().cpu().numpy() for t in o],
                      {k: ex.grad_dict[k].detach().cpu().numpy()
                       for k in params})
        if dev == CARD:
            train_ex = ex
    worst = 0.0
    for c, h in zip(grads[CARD][0], grads["cpu"][0]):
        np.testing.assert_allclose(c, h, rtol=rtol, atol=atol)
    for k in params:
        c, h = grads[CARD][1][k], grads["cpu"][1][k]
        np.testing.assert_allclose(c, h, rtol=rtol, atol=atol, err_msg=k)
        worst = max(worst, float(np.abs(c - h).max()
                                 / max(np.abs(h).max(), 1e-12)))
    roi_grad = float(np.abs(grads[CARD][1]["fc6_weight"]).sum())
    if not roi_grad > 0:
        raise AssertionError("rcnn: no gradient through ROIPooling")

    # timed: eval forwards, then train steps with SGD (example's momentum)
    def forward():
        eval_ex.forward(is_train=False)

    opt = optimizer.create("sgd", learning_rate=1e-3, momentum=0.9,
                           rescale_grad=1.0 / b)
    updater = optimizer.get_updater(opt)
    names = sorted(params)

    def train_step():
        train_ex.forward(is_train=True)
        train_ex.backward()
        for i, name in enumerate(names):
            updater(i, train_ex.grad_dict[name], train_ex.arg_dict[name])

    times, syncs = {}, {}
    for tag, fn in (("forward", forward), ("step", train_step)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with _SyncCounter() as sc:
            t0 = time.perf_counter()
            for _ in range(RCNN_CALLS):
                fn()
            torch.cuda.synchronize()
            times[tag] = (time.perf_counter() - t0) / RCNN_CALLS * 1e3
            syncs[tag] = sc.total() / RCNN_CALLS
    prof = _range_profile(lambda: [forward() for _ in range(3)], 3,
                          ("Proposal.nms",), SSD_KINDS)
    log(_profile_line("rcnn", prof, times["forward"], unit="forward"))
    out = {"forward_ms": times["forward"], "step_ms": times["step"],
           "img_s_forward": b / times["forward"] * 1e3,
           "proposal_nms_launch_calls": prof["range_launch_calls_per_step"][
               "Proposal.nms"],
           "proposal_nms_device_ms": prof["by_kind_ms"]["Proposal.nms"],
           "launch_calls_per_forward": prof["launch_calls_per_step"],
           "idle_share": 1 - prof["busy_ms"] / times["forward"],
           "host_syncs": syncs,
           "eval_max_err": eval_err, "rois_reordered": reordered,
           "grad_worst_rel_err": worst}
    log(f"[rcnn] Faster R-CNN b{b} x 3 x 64 x 64 (stride 4, 3 classes, "
        f"pre/post NMS 64/16, 16 RoIs an image): eval forward "
        f"{times['forward']:.3f} ms ({out['img_s_forward']:.1f} img/s), "
        f"train_rois step {times['step']:.3f} ms (host syncs a forward "
        f"{syncs['forward']:.1f}, a step {syncs['step']:.1f}); Proposal's NMS "
        f"{out['proposal_nms_launch_calls']:.0f} launch calls a forward of "
        f"{prof['launch_calls_per_step']:.0f}; card vs CPU: eval outputs "
        f"within ({rtol}, {atol}) ({reordered} RoI rows in another order), "
        f"the step's gradients worst {worst:.3g} of each tensor's largest; "
        f"{smi}")
    log(f"[rcnn] {json.dumps(out)}")
    if any(syncs.values()):
        raise AssertionError(f"rcnn: host syncs a call {syncs}")
    del eval_ex, train_ex
    torch.cuda.empty_cache()
    return out


def phase_ocr(smi):
    """examples/warpctc/lstm_ocr.py at its defaults: batch 32 of 16 x 48
    seven-segment captchas, ``LSTMCell(48)`` unrolled over the 48
    columns, ``WarpCTC`` (label_length 5), Adam lr 4e-3 through
    ``optimizer.get_updater``: the first step against the port on the CPU
    from the same weights, then 200 steps (steps/s, the CTC loss at the
    first and last step, a profile of the CTC backward) and the greedy
    decode's sequence accuracy on a held-out batch."""
    from mxnet_tpu_torch import optimizer
    from mxnet_tpu_torch.ops import ctc

    b = OCR_BATCH
    net = ocr_net(OCR_HIDDEN, OCR_CLASSES)
    shapes = {"data": (b, OCR_H, OCR_W), "label": (b, OCR_DIGITS),
              "l0_begin_state_0": (b, OCR_HIDDEN),
              "l0_begin_state_1": (b, OCR_HIDDEN)}
    skip = lambda n: n in ("data", "label") or "state" in n  # noqa: E731
    ex = net.simple_bind(CARD, **shapes)
    _xavier_args(net, ex, skip, seed=19)
    names = sorted(n for n in ex.arg_dict if not skip(n))
    params = {k: ex.arg_dict[k].detach().clone() for k in names}
    imgs, labels = ocr_batches(np.random.RandomState(0), OCR_STEPS + 1, b)
    imgs_d = torch.from_numpy(imgs).to(CARD)
    labels_d = torch.from_numpy(labels).to(CARD)

    def loss_of(probs, lab):
        # WarpCTC's output is softmax(pred); log of it is log_softmax
        return ctc.ctc_loss(torch.log(probs), lab).mean()

    # the first step, card against CPU
    first = {}
    for dev in (CARD, "cpu"):
        e = ex if dev == CARD else net.simple_bind("cpu", **shapes)
        e.copy_params_from(params)
        e.forward(is_train=True, data=torch.from_numpy(imgs[0]),
                  label=torch.from_numpy(labels[0]))
        e.backward()
        probs = e.outputs[0].detach()
        first[dev] = (probs.cpu().numpy(),
                      float(loss_of(probs, e.arg_dict["label"])),
                      {k: e.grad_dict[k].detach().cpu().numpy()
                       for k in names})
    rtol, atol = OCR_TOL
    np.testing.assert_allclose(first[CARD][0], first["cpu"][0], rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(first[CARD][1], first["cpu"][1], rtol=rtol)
    gworst = 0.0
    for k in names:
        c, h = first[CARD][2][k], first["cpu"][2][k]
        top = max(float(np.abs(h).max()), 1e-12)
        np.testing.assert_allclose(c, h, rtol=rtol, atol=atol * top,
                                   err_msg=k)
        gworst = max(gworst, float(np.abs(c - h).max()) / top)

    opt = optimizer.create("adam", learning_rate=OCR_LR)
    updater = optimizer.get_updater(opt)
    ex.copy_params_from(params)
    losses = []

    def step(i):
        ex.arg_dict["data"].copy_(imgs_d[i])
        ex.arg_dict["label"].copy_(labels_d[i])
        ex.forward(is_train=True)
        ex.backward()
        for k, name in enumerate(names):
            updater(k, ex.grad_dict[name], ex.arg_dict[name])
        losses.append(loss_of(ex.outputs[0].detach(), labels_d[i]))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(OCR_STEPS):
        step(i)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    curve = torch.stack(losses).cpu().numpy()
    prof = _range_profile(lambda: [step(i) for i in range(2)], 2,
                          ("WarpCTC.backward",), SSD_KINDS)
    ex.forward(is_train=False, data=imgs_d[OCR_STEPS],
               label=labels_d[OCR_STEPS])
    acc = seq_accuracy(ex.outputs[0].cpu().numpy(), labels[OCR_STEPS])
    step_ms = wall / OCR_STEPS * 1e3
    log(_profile_line("ocr", prof, step_ms))
    out = {"steps_s": OCR_STEPS / wall, "step_ms": step_ms,
           "ctc_loss_first_last": [float(curve[0]), float(curve[-1])],
           "first_step_loss_card_cpu": [first[CARD][1], first["cpu"][1]],
           "first_step_grad_worst_rel_err": gworst,
           "heldout_seq_accuracy": acc,
           "ctc_backward_device_ms": prof["by_kind_ms"]["WarpCTC.backward"],
           "ctc_backward_launch_calls": prof["range_launch_calls_per_step"][
               "WarpCTC.backward"],
           "launch_calls_per_step": prof["launch_calls_per_step"],
           "busy_ms": prof["busy_ms"],
           "idle_share": 1 - prof["busy_ms"] / step_ms}
    log(f"[ocr] lstm_ocr b{b}, LSTM 48 over 48 columns, WarpCTC: "
        f"{out['steps_s']:.2f} steps/s ({step_ms:.3f} ms a step, "
        f"{OCR_STEPS} steps); CTC loss {curve[0]:.4f} -> {curve[-1]:.4f}; "
        f"held-out sequence accuracy {acc:.3f}; first step card vs CPU: "
        f"loss {first[CARD][1]:.6f} / {first['cpu'][1]:.6f}, gradients "
        f"worst {gworst:.3g} of each tensor's largest; the CTC backward "
        f"{out['ctc_backward_device_ms']:.3f} device ms and "
        f"{out['ctc_backward_launch_calls']:.0f} launch calls of "
        f"{prof['launch_calls_per_step']:.0f} a step; {smi}")
    log(f"[ocr] {json.dumps(out)}")
    if not curve[-10:].mean() < curve[:10].mean():
        raise AssertionError(f"ocr: the CTC loss did not fall: "
                             f"{curve[:10]} ... {curve[-10:]}")
    del ex
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phases 35-36
AUTOTUNE_CALLS = 50              # timed calls of each paged candidate
EPI_TUNE_CALLS = 50              # timed replays of each epilogue schedule
PLANES_STEPS = 10                # LM steps an epoch of phase_planes
PLANES_DECODE_TICKS = 20         # decode ticks with the perf plane on
PLANES_INF = "layer0_q_weight"   # the parameter the sentinel check poisons
OOM_BYTES = 1 << 40              # one torch.empty far past the card's 80 GB


def _sched_name(sched):
    """``cuda/p8``, ``pagewalk/c2``, ``gather``, ``t256/b8``."""
    if "threads" in sched:
        return f"t{sched['threads']}/b{sched['blocks_per_sm']}"
    knob = ("/p%d" % sched["chunk_pages"] if "chunk_pages" in sched
            else "/c%d" % sched["chunk"] if "chunk" in sched else "")
    return sched["impl"] + knob


def _serve_prompts(V):
    """phase_serve's 16 prompts: 8 behind a shared 256-token prefix."""
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, V, 256).tolist()
    prompts = [prefix + rng.integers(0, V, int(n)).tolist()
               for n in rng.integers(16, 201, 8)]
    return prompts + [rng.integers(0, V, int(n)).tolist()
                      for n in rng.integers(16, 701, 8)]


def _serve_under(dec, prompts, env):
    """The 16 prompts served (32 greedy tokens each) by a paged server
    built under ``env``: ``(tokens, schedule, paged launches, ticks)``."""
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.serving import serve_decoder

    server, sched = _with_env(env, lambda: serve_decoder(
        dec, num_slots=SLOTS, paged=True, kv_block=BLOCK, queue_size=32))
    try:
        port = server.server_address[1]
        _serve_burst(port, [[1, 2, 3]], 2)      # warm-up, outside the counts
        n0, t0 = pa.launch_count(), sched.stats["ticks"]
        replies = _serve_burst(port, prompts, 32)
        return ([r[1]["tokens"] for r in replies],
                dict(sched.backend.schedule), pa.launch_count() - n0,
                sched.stats["ticks"] - t0)
    finally:
        server.shutdown()
        server.server_close()
        sched.close()


def _paged_autotune(cfg, params, smi, wd):
    """The paged half of phase_autotune; returns the served runs' paged
    launches."""
    from mxnet_tpu_torch import autotune as at
    from mxnet_tpu_torch import telemetry as tm
    from mxnet_tpu_torch.models.decode import KVDecoder
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.serving.paged_kv import PagedSlots

    V, L, H = cfg["vocab_size"], cfg["num_layers"], cfg["num_heads"]
    dh, M, dt = cfg["d_model"] // H, MAX_LEN // BLOCK, torch.bfloat16
    dec = KVDecoder(params, num_layers=L, num_heads=H, max_len=MAX_LEN,
                    dtype=dt)
    default = pa.default_schedule("cuda", BLOCK, dh, dt)
    us = {}
    for c in pa.candidate_schedules("cuda", BLOCK, dh, M, dt):
        fn = pa.make_bench_fn(c, B=SLOTS, H=H, M=M, block=BLOCK, dh=dh, L=L,
                              dtype=dt, device=CARD)
        us[_sched_name(c)] = _time_ms(lambda i: fn(), AUTOTUNE_CALLS,
                                      warmup=3) * 1e3
        del fn
    log(f"[autotune] paged candidates, µs per tick's attention over {L} "
        f"layers (B {SLOTS}, H {H}, dh {dh}, 16-token pages, M {M}, bf16, "
        f"cursors spread over the context; CUDA events over "
        f"{AUTOTUNE_CALLS} calls): "
        + "; ".join(f"{k} {v:.2f}" for k, v in us.items())
        + f"; default {_sched_name(default)}; {smi}")
    path = os.path.join(wd, "schedules.json")
    env = {"MXTPU_SCHEDULE_CACHE": "search:" + path}
    trials = tm.get_registry().get("autotune_trials_total")
    buckets = tuple(2 ** i for i in range(3, 11))

    def slots(e, n=SLOTS):
        return _with_env(e, lambda: PagedSlots(dec, n, block=BLOCK,
                                               prefill_buckets=buckets))

    at.reset()
    n0, t0 = trials.total(), time.perf_counter()
    pg = slots(env)
    search_s, n_trials = time.perf_counter() - t0, int(trials.total() - n0)
    won = dict(pg.schedule)
    best = json.load(open(path))["entries"][at.device_kind()][
        "paged_attention|" + pa.keysig(SLOTS, H, M, BLOCK, dh, dt)]
    del pg
    at.reset()                     # a fresh process: the winner from disk
    again = slots(env)
    if again.schedule != won or trials.total() != n0 + n_trials:
        raise AssertionError(f"the second PagedSlots did not hit the "
                             f"cache: {again.schedule} vs {won}, trials "
                             f"{trials.total() - n0 - n_trials}")
    del again
    ro = os.path.join(wd, "readonly.json")
    at.reset()
    kept = slots({"MXTPU_SCHEDULE_CACHE": "readonly:" + ro})
    if os.path.exists(ro) or kept.schedule != default:
        raise AssertionError(f"readonly: {kept.schedule}, file written "
                             f"{os.path.exists(ro)}")
    del kept
    if n_trials != len(us) or won["impl"] != "cuda":
        raise AssertionError(f"search: {n_trials} trials for {len(us)} "
                             f"candidates, winner {won}")
    log(f"[autotune] paged search: {n_trials} trials in {search_s:.2f} s "
        f"(host wall, warm-up 2 + best of 5 each), winner "
        f"{_sched_name(won)} at {best['best_us']} µs (the default "
        f"{_sched_name(default)}: {us[_sched_name(default)]:.2f} µs by "
        f"events); a second PagedSlots: 0 trials, {_sched_name(won)}; "
        f"readonly on a fresh path: nothing written, default kept")
    prompts = _serve_prompts(V)
    at.reset()
    tok_won, sch, n_won, ticks = _serve_under(dec, prompts, env)
    if sch != won:
        raise AssertionError(f"the server ran {sch}, not the winner {won}")
    tok_def, sch, n_def, ticks_d = _serve_under(
        dec, prompts, {"MXTPU_SCHEDULE_CACHE": "off"})
    if sch != default:
        raise AssertionError(f"the untuned server ran {sch}")
    equal = sum(a == b for a, b in zip(tok_won, tok_def))
    # teacher-forced logits of the winner against the default, with
    # phase_parity's bf16 tolerance (a split of other chunks merges the
    # same partials in another order)
    ref, fed = _drive(_with_env({"MXTPU_SCHEDULE_CACHE": "off"},
                                lambda: PagedSlots(
                                    dec, SLOTS, block=BLOCK,
                                    prefill_buckets=buckets)), V)
    got, _ = _drive(slots(env), V, forced=fed)
    errs = [float(np.abs(a - b).max()) for a, b in zip(ref, got)]
    log(f"[autotune] served 16 prompts x 32 greedy tokens under the winner "
        f"({ticks} ticks, {n_won} paged launches) and the default ({ticks_d}"
        f" ticks, {n_def} launches): {equal}/16 token sequences equal; "
        f"teacher-forced logits winner vs default max |diff| {max(errs):.3g}"
        f" (first step {errs[1]:.3g}; phase_parity's bf16 tolerance 1e-2 "
        f"first, 1e-1 all)")
    if equal != len(prompts) and not (errs[1] <= 1e-2 and max(errs) <= 0.1):
        raise AssertionError(f"winner {won} vs default: {equal}/16 equal, "
                             f"logits differ by {max(errs)}")
    if n_def < ticks_d * L or n_won < ticks * L:
        raise AssertionError(f"paged launches {n_won}/{n_def} in "
                             f"{ticks}/{ticks_d} ticks")
    del dec
    torch.cuda.empty_cache()
    return {"paged_us": us, "paged_winner": _sched_name(won),
            "paged_trials": n_trials, "paged_search_s": search_s,
            "paged_launches": n_won + n_def}


def _epilogue_autotune(smi, wd):
    """The epilogue half of phase_autotune; returns its records and the
    tuned Predictor's epilogue launches."""
    from mxnet_tpu_torch import autotune as at
    from mxnet_tpu_torch import telemetry as tm
    from mxnet_tpu_torch.ops import residual_epilogue as tre

    env = {"MXTPU_SCHEDULE_CACHE": "search:" + os.path.join(wd, "epi.json")}
    at.reset()
    fp0 = _with_env(env, at.fingerprint)
    dev = torch.device(CARD)
    g = torch.Generator(device=dev).manual_seed(35)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        for name, hw, c in EPI_TAILS:
            # the Predictor's layout: logical NCHW in channels-last memory
            rows = PREDICT_BATCH * hw
            shape = (PREDICT_BATCH, c, int(hw ** 0.5), int(hw ** 0.5))
            x = torch.randn(shape, generator=g, device=dev).to(dtype) \
                .contiguous(memory_format=torch.channels_last)
            s = torch.randn(shape, generator=g, device=dev).to(dtype) \
                .contiguous(memory_format=torch.channels_last)
            scale = torch.rand((c,), generator=g, device=dev) + 0.5
            bias = torch.rand((c,), generator=g, device=dev) - 0.5
            ref = tre._plain_fwd(x, s, scale, bias, 1)
            base = tre._cuda_fwd(x, s, scale, bias, 1,
                                 schedule=tre.DEFAULT_SCHEDULE)
            diff = (base.float() - ref.float()).abs()
            if not bool((diff <= _epi_tolerance(x, s, scale, ref)).all()):
                raise AssertionError(f"epilogue {name} {tag}: default "
                                     f"schedule off its plain version")
            # timed as tune() times them: replays of a captured pass over
            # copies cold in L2, µs a launch
            bench = tre.make_bench_fn(rows, c, dtype)
            us = {}
            for cand in tre.candidate_schedules():
                got = tre._cuda_fwd(x, s, scale, bias, 1, schedule=cand)
                if not torch.equal(got, base):
                    raise AssertionError(f"epilogue {name} {tag}: schedule "
                                         f"{cand} changed the output")
                thunk = bench(cand)
                n_pass = len(thunk())
                us[_sched_name(cand)] = _time_ms(
                    lambda i: thunk(), EPI_TUNE_CALLS) * 1e3 / n_pass
                del thunk
            t0 = time.perf_counter()
            won = _with_env(env, lambda: tre.tune(rows, c, dtype))
            tune_s = time.perf_counter() - t0
            bound, _ = _epi_bound_ms(rows, c, dtype)
            d = _sched_name(tre.DEFAULT_SCHEDULE)
            w = _sched_name(won)
            out[(tag, name)] = {"rows": rows, "C": c, "us": us, "winner": w,
                                "winner_us": us[w], "default_us": us[d],
                                "bound_us": bound * 1e3, "tune_s": tune_s}
            log(f"[autotune] epilogue {tag} {name} ({rows} x {c}): "
                f"candidates µs a launch (events over {EPI_TUNE_CALLS} "
                f"replays of a captured pass, inputs cold in L2) "
                + " ".join(f"{k} {v:.2f}" for k, v in us.items())
                + f"; every output bit-equal to the default's; tune() "
                f"picked {w} in {tune_s:.2f} s: {us[w]:.2f} µs vs default "
                f"{d} {us[d]:.2f} µs, bound {bound * 1e3:.2f} µs (share "
                f"{bound * 1e3 / us[w]:.3f})")
            del x, s, ref, base, got, bench
    for tag in ("float32", "bfloat16"):
        rows = [r for (t, _), r in out.items() if t == tag]
        ratio = (sum(r["winner_us"] for r in rows)
                 / sum(r["default_us"] for r in rows))
        log(f"[autotune] epilogue {tag}: the four tails under tune()'s "
            f"winners take {ratio:.4f} of the default's µs; {smi}")
    fp1 = _with_env(env, at.fingerprint)
    if fp1 == fp0:
        raise AssertionError("the search did not move the fingerprint")
    # the tuned Predictor against the untuned one, fp32, bit for bit
    net, arg, aux = _resnet50()
    x = np.random.default_rng(3).normal(
        size=(PREDICT_BATCH, 3, 224, 224)).astype(np.float32)
    cache = tm.get_registry().get("executor_graph_cache_total")
    plain = _predictor(net, arg, aux, env={"MXTPU_SCHEDULE_CACHE": "off"})
    plain.forward(data=x)
    want = plain.get_output(0)
    del plain
    m0 = cache.value(result="miss")
    tuned = _predictor(net, arg, aux, env=env)
    misses = cache.value(result="miss") - m0
    used = {name: _sched_name(_with_env(env, lambda: tre._schedule_for(
        PREDICT_BATCH * hw, c, torch.float32))) for name, hw, c in EPI_TAILS}

    def run():
        tuned.forward(data=x)
        return tuned.get_output(0)

    run()
    tre.reset_launch_count()
    got = [_with_env(env, run) for _ in range(3)]
    launches = tre.launch_count()
    if launches != 12 or not all(np.array_equal(o, want) for o in got):
        raise AssertionError(f"tuned Predictor: {launches} epilogue "
                             f"launches in 3 forwards, outputs equal "
                             f"{[np.array_equal(o, want) for o in got]}")
    log(f"[autotune] fingerprint {fp0} -> {fp1} after the search; the "
        f"re-bind missed the program cache {int(misses)} time(s) and its "
        f"fp32 tails run {used}; 3 tuned forwards: {launches} epilogue "
        f"launches, softmax outputs bit-equal to the untuned Predictor's; "
        f"{smi}")
    del tuned
    torch.cuda.empty_cache()
    return out, launches


def phase_autotune(smi, cfg, params):
    """35: the autotuner on the card (see the module docstring).  Returns
    (summary, launches by kernel in its main path runs)."""
    from mxnet_tpu_torch import telemetry as tm

    tm.enable()       # the autotune_* and executor cache counters
    counts = _kernel_launches(reset=True)
    with tempfile.TemporaryDirectory() as wd:
        paged = _paged_autotune(cfg, params, smi, wd)
        epi, epi_launches = _epilogue_autotune(smi, wd)
    counts = {k: 0 for k in counts}
    counts["paged_attention"] = paged["paged_launches"]
    counts["residual_epilogue"] = epi_launches
    return {"paged": paged, "epilogue": epi}, counts


def _lm_epoch(tk, data, label):
    """One ``fit`` epoch over the host batches; ``(wall s, sync counter)``."""
    from mxnet_tpu_torch import io

    it = io.NDArrayIter(data, label, batch_size=TRAIN_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _SyncCounter() as sync:
        tk.fit(it, eval_metric="ce", num_epoch=1,
               batch_end_callback=[sync.mark])
    torch.cuda.synchronize()
    return time.perf_counter() - t0, sync


def phase_planes(smi, cfg, params):
    """36: the health and perf planes on the card (see the module
    docstring).  Returns (summary, launches by kernel in its main path
    runs)."""
    from mxnet_tpu_torch import telemetry as tm
    from mxnet_tpu_torch.models import transformer as tr
    from mxnet_tpu_torch.models.decode import KVDecoder
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.serving.scheduler import SlotScheduler
    from mxnet_tpu_torch.telemetry import health, perf
    from mxnet_tpu_torch.trainer import FusedTrainer

    B, T, V, L = TRAIN_BATCH, cfg["seq_len"], cfg["vocab_size"], \
        cfg["num_layers"]
    rng = np.random.default_rng(0)
    data = rng.integers(0, V, (B * PLANES_STEPS, T)).astype(np.float32)
    label = rng.integers(0, V, (B * PLANES_STEPS, T)).astype(np.float32)
    fpt = tr.lm_train_flops_per_token(L, cfg["d_model"], cfg["d_ff"], T, V)
    counts = {k: 0 for k in _kernel_launches(reset=True)}
    tm.enable()
    label_of = "fused_step[%s]" % (tr.transformer_lm(**cfg).name or "graph")
    out = {}
    with tempfile.TemporaryDirectory() as wd:
        dump = os.path.join(wd, "flight.json")
        on = {"MXTPU_SENTINEL": "raise", "MXTPU_FLIGHT_RECORD": dump}
        off = {"MXTPU_SENTINEL": "0", "MXTPU_FLIGHT_RECORD": "0"}

        def trainer():
            return FusedTrainer(tr.transformer_lm(**cfg), optimizer="adam",
                                optimizer_params={"lr": 1e-4},
                                dtype="bfloat16").init(
                data=(B, T), softmax_label=(B, T))

        health._ring.clear()
        perf.reset()
        perf.enable()
        tk = _with_env(on, trainer)
        _with_env(on, lambda: _lm_epoch(tk, data, label))   # warm, counted
        cost = [r for r in perf.cost_table() if r["program"] == label_of]
        perf.reset(costs=False)
        fa.reset_launch_counts()
        wall_on, sync = _with_env(on, lambda: _lm_epoch(tk, data, label))
        flash = fa.launch_counts()
        per_batch = [b - a for a, b in zip(sync.marks, sync.marks[1:])]
        if (len(sync.marks) != PLANES_STEPS or any(per_batch)
                or sync.marks[0]):
            raise AssertionError(f"planes on: host syncs per batch "
                                 f"{sync.marks}")
        if flash != {k: L * PLANES_STEPS for k in flash}:
            raise AssertionError(f"flash launches {flash}")
        prof = perf.profile_payload()
        row = [p for p in prof["programs"] if p["program"] == label_of][0]
        ring = len(health.flight_ring())
        srv = tm.start_http_server(0)
        try:
            top = _get(srv.server_address[1], "/profile")["programs"][:3]
        finally:
            srv.shutdown()
        own_mfu = B * T * PLANES_STEPS / wall_on * fpt \
            / PEAK_FLOPS[torch.bfloat16]
        flops = cost[0]["flops"] if cost else None
        log(f"[planes] LM fit, {PLANES_STEPS} steps of {B} x {T} with "
            f"MXTPU_PERF_ATTR, MXTPU_FLIGHT_RECORD and MXTPU_SENTINEL=raise: "
            f"step {wall_on / PLANES_STEPS * 1e3:.2f} ms; host syncs per "
            f"batch {per_batch} (epoch boundary "
            f"{sync.total() - sync.marks[-1]}: the metric and the "
            f"sentinel); plane MFU {row['mfu']:.4f} (counted FLOPs x "
            f"dispatches over the steps' host dispatch wall "
            f"{row['wall_s']:.3f} s) vs this script's {own_mfu:.4f} (model "
            f"FLOPs {fpt * B * T / 1e12:.3f} T a step over the epoch's wall);"
            f" cost row FLOPs {flops / 1e12 if flops else float('nan'):.4f} "
            f"T ({cost[0]['source'] if cost else 'none'}) vs the analytic "
            f"model count {fpt * B * T / 1e12:.4f} T (ratio "
            f"{(flops or 0) / (fpt * B * T):.4f}); flight ring "
            f"{ring} records; buckets "
            + ", ".join(f"{k} {v['seconds']:.3f} s"
                        for k, v in prof["buckets"].items())
            + f"; /profile top rows "
            + "; ".join(f"{p['program']}: {p['dispatches']} x, "
                        f"{p['wall_s']:.3f} s, mfu {p['mfu']}"
                        for p in top) + f"; flash launches {flash}; {smi}")
        if not cost or not flops or ring < PLANES_STEPS:
            raise AssertionError(f"planes: cost row {cost}, ring {ring}")
        counts.update(flash)
        out.update(step_ms_on=wall_on / PLANES_STEPS * 1e3,
                   plane_mfu=row["mfu"], own_mfu=own_mfu, cost_flops=flops,
                   model_flops=fpt * B * T, ring=ring)
        # one parameter set to inf: the sentinel names it at the boundary,
        # and fit writes the flight record on its way out
        with torch.no_grad():
            tk.params[PLANES_INF].view(-1)[0] = float("inf")
        tk._refresh_compute_cache()
        step0 = tk._step
        try:
            _with_env(on, lambda: _lm_epoch(tk, data[:2 * B], label[:2 * B]))
        except health.NumericsError as exc:
            msg = str(exc)
        else:
            raise AssertionError("an inf parameter raised no NumericsError")
        if PLANES_INF not in msg or f"step {step0 + 1} " not in msg:
            raise AssertionError(f"NumericsError does not name "
                                 f"{PLANES_INF} at step {step0 + 1}: {msg}")
        record = json.load(open(dump))
        log(f"[planes] {PLANES_INF}[0] = inf: NumericsError at the epoch "
            f"boundary: {msg[:160]}...; flight record written "
            f"({record['trigger']}, {len(record['ring'])} ring records, "
            f"{os.path.getsize(dump)} bytes)")
        del tk
        gc.collect()
        torch.cuda.empty_cache()
        # the planes off: the same step
        perf.disable()
        tk = _with_env(off, trainer)
        _with_env(off, lambda: _lm_epoch(tk, data, label))
        wall_off, _ = _with_env(off, lambda: _lm_epoch(tk, data, label))
        del tk
        gc.collect()
        torch.cuda.empty_cache()
        out["step_ms_off"] = wall_off / PLANES_STEPS * 1e3
        log(f"[planes] step ms with the planes on "
            f"{out['step_ms_on']:.2f}, off {out['step_ms_off']:.2f} (ratio "
            f"{out['step_ms_on'] / out['step_ms_off']:.4f}); {smi}")
    # an allocator failure: one oversized torch.empty
    try:
        try:
            torch.empty(OOM_BYTES, dtype=torch.uint8, device=CARD)
        except Exception as exc:  # noqa: BLE001 — the dispatch-site guard
            health.reraise_if_oom(exc, site="chip_smoke.empty")
            raise
    except health.DeviceOOMError as exc:
        report = str(exc)
    else:
        raise AssertionError("an oversized torch.empty did not fail")
    # the caching allocator's line exists on a card only
    for want in ("ranked by peak",) + (("caching allocator",)
                                       if CARD == "cuda" else ()):
        if want not in report:
            raise AssertionError(f"the OOM report lacks {want!r}: {report}")
    log(f"[planes] torch.empty of {OOM_BYTES} bytes: DeviceOOMError with "
        f"the ranked report ({len(report.splitlines())} lines): "
        + " | ".join(report.splitlines()[1:4]))
    # 20 decode ticks with the perf plane on
    perf.reset()
    perf.enable()
    dec = KVDecoder(params, num_layers=L, num_heads=cfg["num_heads"],
                    max_len=MAX_LEN, dtype=torch.bfloat16)
    sched = _with_env({"MXTPU_SCHEDULE_CACHE": "off"}, lambda: SlotScheduler(
        dec, num_slots=SLOTS, queue_size=32, paged=True, kv_block=BLOCK))
    try:
        sched.generate([1, 2, 3], max_new_tokens=2, timeout=600)  # warm-up
        t0 = sched.stats["ticks"]
        pa.reset_launch_count()
        # the first token comes from the prefill, the rest from ticks
        reqs = [sched.submit(p[:100], max_new_tokens=PLANES_DECODE_TICKS + 1)
                for p in _serve_prompts(V)[:SLOTS]]
        for r in reqs:
            r.wait(600)
        ticks = sched.stats["ticks"] - t0
        paged = pa.launch_count()
    finally:
        sched.close()
        perf.disable()
    if not all(r.outcome == "ok" for r in reqs) or ticks < \
            PLANES_DECODE_TICKS or paged < ticks * L:
        raise AssertionError(f"decode ticks {ticks}, paged launches "
                             f"{paged}, outcomes "
                             f"{[r.outcome for r in reqs]}")
    rows = {r["program"]: r for r in perf.cost_table()}
    buckets = perf.bucket_table()
    step_row = rows.get("decode_step_paged")
    if not step_row or not step_row["flops"] or buckets.get(
            "dispatch", {}).get("count", 0) < PLANES_DECODE_TICKS:
        raise AssertionError(f"decode cost rows {sorted(rows)}, buckets "
                             f"{buckets}")
    log(f"[planes] {ticks} decode ticks ({SLOTS} slots, "
        f"{PLANES_DECODE_TICKS + 1} tokens each) with the "
        f"perf plane on: cost rows "
        + "; ".join(f"{k} {v['flops'] / 1e9:.3f} GFLOP" for k, v in
                    sorted(rows.items()))
        + "; buckets " + ", ".join(f"{k} {v['seconds'] * 1e3:.1f} ms / "
                                    f"{v['count']}"
                                    for k, v in buckets.items())
        + f"; paged launches {paged} (= {paged / ticks:.1f} a tick); {smi}")
    counts["paged_attention"] = paged
    out["decode_rows"] = sorted(rows)
    perf.reset()
    del dec
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


# ------------------------------------------------------------ phases 37-39
CPRED_CLIENT = "mxnet_tpu_torch/csrc/clients/predict.c"
CAPI_CLIENT = "mxnet_tpu_torch/csrc/clients/train_step.cc"
CPP_EXAMPLE = "bindings/cpp/example_train.cc"
CPRED_CALLS = 20                 # timed SetInput + Forward + GetOutput calls
CPRED_INPROC_CALLS = 3           # forwards through the library in process
CAPI_STEPS = 3                   # forward + backward + sgd_update steps
CAPI_LR = 0.05
# a gradient that is zero but for rounding (_scale_invariant_gammas):
# its norm against the median norm of the other gammas' gradients
CAPI_ZERO_GRAD = 1e-2
# the C clients run in fresh processes, whose torch starts with cuDNN's
# TF32 on: the override keeps their fp32 products in full fp32
TF32_OFF = {"NVIDIA_TF32_OVERRIDE": "0"}
# what the C++ training client's embedded interpreter runs at start-up
# (a sitecustomize first on its path): PyTorch's deterministic
# algorithms, which the Python side of the gradient comparison uses too
# (cuBLAS's workspace: CUBLAS_WORKSPACE_CONFIG, inherited from main)
DETERMINISTIC_SITE = "import torch\ntorch.use_deterministic_algorithms(True)\n"
IMPORT_PROBE = ("import time; t = time.perf_counter(); import torch, "
                "mxnet_tpu_torch; torch.zeros(1, device='cuda'); "
                "print(time.perf_counter() - t)")
NATIVE_TASKS = 5000              # empty host tasks timed per backend
TEL_BATCHES = 12                 # record batches rerun with telemetry on


def _client_build(cmd, what):
    """Compile a C/C++ client; raise with the compiler's output."""
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"{what} does not build:\n{r.stderr[-4000:]}")
    return time.perf_counter() - t0


def _client_run(cmd, env, what, timeout=600):
    """Run a C/C++ client; its stdout, or raise with its output's tail
    and the card's free memory when it started."""
    free, total = torch.cuda.mem_get_info()
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0:
        raise AssertionError(
            f"{what} exited {r.returncode} (the card had {free / 2**30:.1f}"
            f" of {total / 2**30:.1f} GiB free; this process reserved "
            f"{torch.cuda.memory_reserved() / 2**30:.1f}):\n"
            f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    return r.stdout, time.perf_counter() - t0


def _link_cmd(src, lib, exe):
    from mxnet_tpu_torch import libinfo

    cc = ["gcc"] if src.endswith(".c") else ["g++", "-std=c++17"]
    return cc + ["-O2", src, *(f"-I{d}" for d in libinfo.include_dirs()),
                 lib, "-lm", "-o", exe, f"-Wl,-rpath,{os.path.dirname(lib)}"]


def _pred_lib(path):
    """The predict library loaded into this process through ctypes."""
    lib = ctypes.CDLL(path)
    lib.MXPredGetLastError.restype = ctypes.c_char_p
    lib.MXPredCreate.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint32, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_void_p)]
    lib.MXPredSetInput.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_void_p, ctypes.c_uint32]
    lib.MXPredGetOutput.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                    ctypes.c_void_p, ctypes.c_uint32]
    lib.MXPredForward.argtypes = [ctypes.c_void_p]
    lib.MXPredForwardAsync.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int64)]
    lib.MXPredGetOutputAsync.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_uint32, ctypes.c_void_p,
                                         ctypes.c_uint32]
    lib.MXPredFree.argtypes = [ctypes.c_void_p]

    def check(rc, what):
        if rc != 0:
            raise AssertionError(f"{what}: {lib.MXPredGetLastError()}")
    return lib, check


def phase_c_predict(smi):
    """ResNet-50 at batch 32 in fp32 through the predict ABI: a C program
    (csrc/clients/predict.c) against the port's predict library on the
    card (dev_type 2) from the symbol's JSON and the bytes of an
    ``nd.save`` file, 20 timed calls; its probabilities against the
    Python ``Predictor`` in this process (both with TF32 off); then the
    same library loaded here through ctypes, whose forwards launch the
    epilogue 4 times each, every launch held against the plain version,
    and ``MXPredForwardAsync``/``GetOutputAsync`` over the same input.
    Returns (record, launches)."""
    from mxnet_tpu_torch import libinfo
    from mxnet_tpu_torch import ndarray as tnd
    from mxnet_tpu_torch.ops import residual_epilogue as tre
    from mxnet_tpu_torch.predict import Predictor

    n = PREDICT_BATCH
    net, arg, aux = _resnet50()
    x = np.random.default_rng(3).normal(size=(n, 3, 224, 224)).astype(
        np.float32)
    out = {}
    with tempfile.TemporaryDirectory() as wd:
        sym_path, params = os.path.join(wd, "net.json"), \
            os.path.join(wd, "net.params")
        with open(sym_path, "w") as f:
            f.write(net.tojson())
        tnd.save(params, {**{f"arg:{k}": tnd.array(v, ctx="cpu")
                             for k, v in arg.items()},
                          **{f"aux:{k}": tnd.array(v, ctx="cpu")
                             for k, v in aux.items()}})
        x.tofile(os.path.join(wd, "x.f32"))
        t0 = time.perf_counter()
        lib = libinfo.find_lib_path("predict")
        build_s = time.perf_counter() - t0
        exe = os.path.join(wd, "predict")
        cc_s = _client_build(_link_cmd(CPRED_CLIENT, lib, exe), CPRED_CLIENT)
        probs_path = os.path.join(wd, "probs.f32")
        stdout, run_s = _client_run(
            [exe, sym_path, params, os.path.join(wd, "x.f32"), probs_path,
             "2", str(CPRED_CALLS), str(n), "3", "224", "224"],
            libinfo.client_env({**os.environ, **TF32_OFF}), CPRED_CLIENT)
        if "PREDICT OK" not in stdout:
            raise AssertionError(f"C predict client: {stdout[-2000:]}")
        # what a fresh interpreter spends before MXPredCreate's own work
        probe, _ = _client_run([sys.executable, "-c", IMPORT_PROBE],
                               libinfo.client_env(), "import probe")
        import_s = float(probe.strip().splitlines()[-1])
        c_probs = np.fromfile(probs_path, np.float32).reshape(n, 1000)
        c_rate = float(re.search(r"images/s ([\d.]+)", stdout).group(1))
        calls_ms = [float(v) for v in re.findall(r"call \d+ ms ([\d.]+)",
                                                 stdout)]
        create_ms = float(re.search(r"create ms ([\d.]+)", stdout).group(1))
        with open(params, "rb") as f:
            blob = f.read()
    log(f"[c_predict] libmxtpu_predict built or found in {build_s:.2f} s, "
        f"client compiled in {cc_s:.2f} s; the C program ran {run_s:.1f} s "
        f"(MXPredCreate {create_ms:.0f} ms, of which a fresh interpreter's "
        f"import of torch and the port and CUDA's start take about "
        f"{import_s:.1f} s): resnet50 b{n} fp32 "
        f"{c_rate:.2f} images/s over {CPRED_CALLS} calls of SetInput + "
        f"Forward + GetOutput after 3 (median call "
        f"{np.median(calls_ms):.3f} ms), "
        f"the async tickets equal to the synchronous output; "
        f"NVIDIA_TF32_OVERRIDE=0; {smi}")
    if c_probs.shape != (n, 1000) or not np.isfinite(c_probs).all() or \
            not np.allclose(c_probs.sum(1), 1.0, atol=1e-3):
        raise AssertionError("C predict: probabilities not finite rows of 1")

    # the Python Predictor in this process on the same JSON and bytes
    p = Predictor(symbol_json_str=net.tojson(), param_bytes=blob,
                  input_shapes={"data": (n, 3, 224, 224)}, dev_type="cuda")
    for _ in range(3):
        p.forward(data=x)
        py_probs = p.get_output(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CPRED_CALLS):
        p.forward(data=x)
        py_probs = p.get_output(0)
    py_rate = n * CPRED_CALLS / (time.perf_counter() - t0)
    err = float(np.abs(c_probs - py_probs).max())
    log(f"[c_predict-parity] C program vs the Python Predictor: max |prob "
        f"diff| {err:.3g} (tol {MODULE_PREDICT_TOL}); images/s C ABI "
        f"{c_rate:.2f} vs Python {py_rate:.2f} (ratio "
        f"{c_rate / py_rate:.4f}); {smi}")
    if not err <= MODULE_PREDICT_TOL:
        raise AssertionError(f"C predict vs Predictor: {err}")
    del p

    # the same library in this process: the main path's counted run
    plib, check = _pred_lib(lib)
    keys = (ctypes.c_char_p * 1)(b"data")
    indptr = (ctypes.c_uint32 * 2)(0, 4)
    shape = (ctypes.c_uint32 * 4)(n, 3, 224, 224)
    h = ctypes.c_void_p()
    check(plib.MXPredCreate(net.tojson().encode(), blob, len(blob), 2, 0, 1,
                            keys, indptr, shape, ctypes.byref(h)),
          "MXPredCreate")
    got = np.empty((n, 1000), np.float32)
    xp = x.ctypes.data_as(ctypes.c_void_p)
    gp = got.ctypes.data_as(ctypes.c_void_p)
    check(plib.MXPredSetInput(h, b"data", xp, x.size), "MXPredSetInput")
    check(plib.MXPredForward(h), "MXPredForward")       # warm-up
    check(plib.MXPredGetOutput(h, 0, gp, got.size), "MXPredGetOutput")
    _kernel_launches(reset=True)
    with _EpilogueRecorder() as recorder:
        t0 = time.perf_counter()
        for _ in range(CPRED_INPROC_CALLS):
            check(plib.MXPredSetInput(h, b"data", xp, x.size),
                  "MXPredSetInput")
            check(plib.MXPredForward(h), "MXPredForward")
            check(plib.MXPredGetOutput(h, 0, gp, got.size),
                  "MXPredGetOutput")
        inproc_ms = (time.perf_counter() - t0) / CPRED_INPROC_CALLS * 1e3
        tickets = [ctypes.c_int64(), ctypes.c_int64()]
        for t in tickets:
            check(plib.MXPredForwardAsync(h, ctypes.byref(t)),
                  "MXPredForwardAsync")
        asyncs = [np.empty((n, 1000), np.float32) for _ in tickets]
        for t, a in zip(reversed(tickets), reversed(asyncs)):
            check(plib.MXPredGetOutputAsync(
                h, t, 0, a.ctypes.data_as(ctypes.c_void_p), a.size),
                "MXPredGetOutputAsync")
    launches = _kernel_launches()
    checked = recorder.check("c_predict in process")
    plib.MXPredFree(h)
    forwards = CPRED_INPROC_CALLS + len(tickets)
    if launches["residual_epilogue"] != 4 * forwards or checked != \
            4 * forwards or any(v for k, v in launches.items()
                                if k != "residual_epilogue"):
        raise AssertionError(f"c_predict in process: {launches}, {checked} "
                             f"checked; want 4 epilogue launches in each of "
                             f"{forwards} forwards")
    err_in = float(np.abs(got - c_probs).max())
    err_async = max(float(np.abs(a - got).max()) for a in asyncs)
    log(f"[c_predict-inproc] the library through ctypes in this process: "
        f"{forwards} forwards ({CPRED_INPROC_CALLS} sync at "
        f"{inproc_ms:.3f} ms a call, 2 async tickets), "
        f"{launches['residual_epilogue']} epilogue launches each held "
        f"against the plain version; max |prob diff| vs the C program "
        f"{err_in:.3g}, async vs sync {err_async:.3g} (tol "
        f"{MODULE_PREDICT_TOL}); {smi}")
    if not (err_in <= MODULE_PREDICT_TOL and err_async <= MODULE_PREDICT_TOL):
        raise AssertionError(f"in-process C ABI: {err_in}, {err_async}")
    out = {"c_img_s": c_rate, "python_img_s": py_rate, "max_prob_diff": err,
           "create_ms": create_ms, "fresh_import_s": import_s,
           "inproc_call_ms": inproc_ms,
           "epilogue_launches": launches["residual_epilogue"]}
    log(f"[c_predict] {json.dumps(out)}")
    torch.cuda.empty_cache()
    return out, launches


def _scale_invariant_gammas(net):
    """The ``*_gamma`` of each BatchNorm whose output reaches the loss
    only through ReLU and max pooling into other BatchNorms.  In training
    mode those normalise each channel again, so the loss does not change
    with that channel's scale: the exact gradient of such a gamma is zero
    (but for BN's eps) and its computed value is rounding, whose relative
    error between two summation orders is of order one.  ResNet-50's
    ``bn0`` (-> relu0 -> pool0 -> stage1_unit1_bn1, whose output also
    feeds the first shortcut) is one."""
    consumers = {}
    for node in net.nodes:
        for src, _ in node.inputs:
            consumers.setdefault(id(src), []).append(node)
    passes = {("Activation", "act_type", "relu"),
              ("Pooling", "pool_type", "max")}
    found = []
    for node in net.nodes:
        if node.op != "BatchNorm" or str(node.attrs.get(
                "fix_gamma", "True")).lower() in ("true", "1"):
            continue
        frontier, invariant = [node], True
        while frontier and invariant:
            for c in consumers.get(id(frontier.pop()), []):
                if c.op == "BatchNorm":
                    continue
                if any(c.op == op and str(c.attrs.get(k, v)) == v
                       for op, k, v in passes):
                    frontier.append(c)
                else:
                    invariant = False
        if invariant:
            found.append(node.name + "_gamma")
    return found


def phase_c_api(smi):
    """ResNet-50 at batch 32 trained from C++ through the general C API:
    csrc/clients/train_step.cc on ``mxtpu.hpp`` binds it on the card
    (``MXExecutorSimpleBind``, dev_type 2), takes 3 steps of
    forward(is_train=1) + backward with every weight updated on the card
    by ``MXImperativeInvoke("sgd_update")``; its first gradients against
    the port's Python ``Executor`` in this process from the same weights
    and batch (``MODULE_TOL["vs_trainer"]``), both under
    ``torch.use_deterministic_algorithms`` (a ``sitecustomize`` on the
    client's path sets it in its embedded interpreter).  The gammas whose
    exact gradient is zero (``_scale_invariant_gammas``: ``bn0_gamma``)
    are held instead to vanish on both sides, each gradient's norm under
    ``CAPI_ZERO_GRAD`` of the median gamma gradient's; then
    ``bindings/cpp/example_train.cc``, unchanged, against the same
    library (it binds the CPU: the binding's own check).  Returns
    (record, launches)."""
    from mxnet_tpu_torch import libinfo
    from mxnet_tpu_torch import ndarray as tnd
    from mxnet_tpu_torch.executor import simple_bind

    n = RESNET_BATCH
    net, arg, _ = _resnet50()
    names = [k for k in net.list_arguments()
             if k not in ("data", "softmax_label")]
    rs = np.random.RandomState(11)
    x = rs.uniform(0, 1, (n, 3, 224, 224)).astype(np.float32)
    y = rs.randint(0, 1000, n).astype(np.float32)
    rescale = 1.0 / n
    with tempfile.TemporaryDirectory() as wd:
        paths = {k: os.path.join(wd, k) for k in
                 ("net.json", "w.f32", "x.f32", "y.f32", "g.f32")}
        with open(paths["net.json"], "w") as f:
            f.write(net.tojson())
        np.concatenate([arg[k].ravel() for k in names]).tofile(
            paths["w.f32"])
        x.tofile(paths["x.f32"])
        y.tofile(paths["y.f32"])
        t0 = time.perf_counter()
        lib = libinfo.find_lib_path("capi")
        build_s = time.perf_counter() - t0
        exe = os.path.join(wd, "train_step")
        cc_s = _client_build(_link_cmd(CAPI_CLIENT, lib, exe), CAPI_CLIENT)
        site_dir = os.path.join(wd, "site")
        os.makedirs(site_dir)
        with open(os.path.join(site_dir, "sitecustomize.py"), "w") as f:
            f.write(DETERMINISTIC_SITE)
        env = libinfo.client_env({**os.environ, **TF32_OFF})
        env["PYTHONPATH"] = site_dir + os.pathsep + env["PYTHONPATH"]
        _kernel_launches(reset=True)
        stdout, run_s = _client_run(
            [exe, paths["net.json"], paths["w.f32"], paths["x.f32"],
             paths["y.f32"], paths["g.f32"], "2", str(CAPI_STEPS),
             str(CAPI_LR), repr(rescale), str(n), "3", "224", "224"],
            env, CAPI_CLIENT)
        flat = np.fromfile(paths["g.f32"], np.float32)
        example = os.path.join(wd, "example_train")
        _client_build(_link_cmd(CPP_EXAMPLE, lib, example), CPP_EXAMPLE)
        ex_out, ex_s = _client_run([example], libinfo.client_env(),
                                   CPP_EXAMPLE)
    if "TRAIN STEP OK" not in stdout:
        raise AssertionError(f"C++ train_step: {stdout[-2000:]}")
    if "CPP TRAIN OK" not in ex_out:
        raise AssertionError(f"example_train.cc: {ex_out[-2000:]}")
    step_ms = [float(v) for v in re.findall(r"ms ([\d.]+) loss", stdout)]
    losses = [float(v) for v in re.findall(r"loss ([-\d.]+)", stdout)]
    if len(step_ms) != CAPI_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"C++ train_step: {stdout[-2000:]}")
    c_grads, off = {}, 0
    for k in names:
        c_grads[k] = torch.from_numpy(
            flat[off:off + arg[k].size].reshape(arg[k].shape))
        off += arg[k].size
    if off != flat.size:
        raise AssertionError(f"C++ gradients: {flat.size} values, want {off}")

    # the Python executor in this process, the same weights and batch
    ex = simple_bind(net, "cuda", grad_req="write", data=x.shape,
                     softmax_label=y.shape)
    ex.copy_params_from({k: arg[k] for k in names}, {},
                        allow_extra_params=True)
    xd, yd = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()

    def grads(deterministic):
        torch.use_deterministic_algorithms(deterministic)
        try:
            ex.forward(is_train=True, data=xd, softmax_label=yd)
            ex.backward()
        finally:
            torch.use_deterministic_algorithms(False)
        return {k: ex.grad_dict[k].detach().float().cpu() for k in names}

    py_grads = grads(True)
    zero = _scale_invariant_gammas(net)
    scale = float(np.median([float(g.norm()) for k, g in py_grads.items()
                             if k.endswith("_gamma") and k not in zero]))
    vanish = {k: (float(c_grads[k].norm()) / scale,
                  float(py_grads[k].norm()) / scale) for k in zero}
    worst, where, median = _rel_errs(
        c_grads, {k: g for k, g in py_grads.items() if k not in zero})
    # the same step again in this process, with the deterministic
    # algorithms and without them: the spread between two runs
    again = _rel_errs(grads(True), py_grads)
    free = _rel_errs(grads(False), py_grads)
    ranked = sorted(((_rel_err(c_grads[k], py_grads[k]), k) for k in names),
                    reverse=True)[:4]
    tol_max, tol_med = MODULE_TOL["vs_trainer"]
    # the Python side of the same loop, timed like the client's step
    py_ms = []
    for _ in range(CAPI_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.forward(is_train=True)
        ex.backward()
        for k in names:
            tnd.sgd_update(tnd.NDArray(ex.arg_dict[k]),
                           tnd.NDArray(ex.grad_dict[k]), lr=CAPI_LR,
                           rescale_grad=rescale)
        torch.cuda.synchronize()
        py_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _kernel_launches()
    log(f"[c_api] C++ (mxtpu.hpp) ResNet-50 b{n} fp32 on the card through "
        f"libmxtpu_capi (built or found in {build_s:.2f} s, client compiled "
        f"in {cc_s:.2f} s, ran {run_s:.1f} s): step ms "
        + ", ".join(f"{v:.1f}" for v in step_ms) + " (forward + backward + "
        f"{len(names)} sgd_update invokes + MXNDArrayWaitAll), losses "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f"; Python executor, same step: "
        + ", ".join(f"{v:.1f}" for v in py_ms)
        + f" ms; first gradients vs the Python Executor: max rel err "
        f"{worst:.3g} ({where}), median {median:.3g} (tol {tol_max}, "
        f"{tol_med}; deterministic algorithms on both sides) over every "
        f"parameter but {zero}, whose exact gradient is zero: norm over "
        f"the median gamma gradient's, C++ vs Python, "
        + ", ".join(f"{k} {a:.3g} vs {b:.3g}" for k, (a, b) in
                    vanish.items())
        + f" (under {CAPI_ZERO_GRAD}); all parameters: the worst "
        + ", ".join(f"{k} {e:.3g}" for e, k in ranked)
        + f"; a second Python run: max {again[0]:.3g} ({again[1]}); one "
        f"without the deterministic algorithms: max {free[0]:.3g} "
        f"({free[1]}), median {free[2]:.3g}; NVIDIA_TF32_OVERRIDE=0; "
        f"{smi}")
    log(f"[c_api-example] bindings/cpp/example_train.cc unchanged against "
        f"the port's library ({ex_s:.1f} s): "
        + " | ".join(ex_out.strip().splitlines()[-2:]))
    if not (worst <= tol_max and median <= tol_med):
        raise AssertionError(f"C++ gradients vs Executor: {worst} ({where}),"
                             f" median {median}")
    if zero != ["bn0_gamma"] or not all(
            max(v) <= CAPI_ZERO_GRAD for v in vanish.values()):
        raise AssertionError(f"zero gradients {zero}: {vanish}")
    if losses[-1] >= losses[0]:
        raise AssertionError(f"C++ training: losses {losses}")
    del ex
    torch.cuda.empty_cache()
    out = {"step_ms": step_ms, "python_step_ms": py_ms, "losses": losses,
           "grad_max_rel_err": worst, "grad_median_rel_err": median,
           "zero_grads": vanish,
           "rerun_max_rel_err": again[0],
           "nondeterministic_max_rel_err": free[0]}
    log(f"[c_api] {json.dumps(out)}")
    return out, launches


def _native_engine_check(backend):
    """The engine of ``backend``: writers of a var in push order, its
    readers side by side, a task's error raised at ``wait_for_var``,
    and the push rate of empty tasks."""
    from mxnet_tpu_torch import _native

    eng = _native.NativeEngine(num_threads=8, backend=backend)
    try:
        v = eng.new_var()
        order = []
        for i in range(200):
            eng.push(lambda i=i: order.append(i), mutable_vars=[v])
        active, peak = [0], [0]
        lock = threading.Lock()

        def reader():
            with lock:
                active[0] += 1
                peak[0] = max(peak[0], active[0])
            time.sleep(0.02)
            with lock:
                active[0] -= 1

        for _ in range(8):
            eng.push(reader, const_vars=[v])
        eng.push(lambda: order.append("w"), mutable_vars=[v])
        eng.wait_for_var(v)
        if order != list(range(200)) + ["w"] or peak[0] < 2:
            raise AssertionError(f"engine {backend}: order {order[-3:]}, "
                                 f"{peak[0]} readers at once")

        def boom():
            raise RuntimeError("raised by a task")

        eng.push(boom, mutable_vars=[v])
        try:
            eng.wait_for_var(v)
        except RuntimeError as e:
            if "raised by a task" not in str(e):
                raise
        else:
            raise AssertionError(f"engine {backend}: the error was lost")
        w = eng.new_var()
        t0 = time.perf_counter()
        for _ in range(NATIVE_TASKS):
            eng.push(_noop, mutable_vars=[w])
        eng.wait_all()
        rate = NATIVE_TASKS / (time.perf_counter() - t0)
    finally:
        eng._shutdown()
    return {"readers_at_once": peak[0], "tasks_per_s": rate}


def _noop():
    pass


def _telemetry_rerun(smi, recs, img_s):
    """phase_record_iter's stacked route at 4 threads with telemetry on:
    ``data_batches_total`` of the consumer-facing stage equal to the
    batches consumed, the wait histogram counting as many, 0 host syncs
    a batch on the consuming thread, images/s beside the same route's
    with telemetry off."""
    from mxnet_tpu_torch import telemetry as tm

    route = "ImageRecordIter threads=4 -> PrefetchingIter -> " \
            "DevicePrefetchIter"
    tm.reset()
    tm.enable()
    base = _record_iter(recs["train"], 4)
    it = _stacked(base)
    acc = torch.zeros((), device=CARD, dtype=torch.float64)
    n = 0
    try:
        with _ConsumerSyncs() as syncs:
            t0 = time.perf_counter()
            for batch in it:
                acc += batch.data[0].tensor.sum(dtype=torch.float64)
                n += 1
                if n == TEL_BATCHES:
                    break
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        snap = tm.json_snapshot()["metrics"]
    finally:
        tm.reset()
        tm.enable(False)
    counts = {s["labels"]["iterator"]: s["value"]
              for s in snap["data_batches_total"]["samples"]}
    waits = {s["labels"]["iterator"]: s["count"]
             for s in snap["data_batch_wait_seconds"]["samples"]}
    rate = n * REC_BATCH / wall
    log(f"[native-telemetry] {route} with telemetry on: {n} batches "
        f"consumed; data_batches_total {json.dumps(counts)}; "
        f"data_batch_wait_seconds counts {json.dumps(waits)}; host syncs "
        f"{syncs.total()} in {n} batches; {rate:.1f} img/s (off, "
        f"phase 15: {img_s.get(route, float('nan')):.1f}; {n} batches from "
        f"a cold start here, {REC_TIMED} after {REC_WARMUP} there); {smi}")
    if not math.isfinite(acc.item()):
        raise AssertionError("telemetry rerun: non-finite batch sums")
    want = "DevicePrefetchIter"
    if counts.get(want) != n or waits.get(want) != n or syncs.total():
        raise AssertionError(f"telemetry rerun: {counts}, {waits}, "
                             f"{syncs.total()} syncs for {n} batches")
    if counts.get("PrefetchingIter", 0) < n or \
            counts.get("ImageRecordIter", 0) < n:
        raise AssertionError(f"telemetry rerun: upstream stages {counts}")
    return {"batches": n, "counts": counts, "syncs": syncs.total(),
            "img_s": rate}


def phase_native(smi, recs, img_s):
    """The native runtime on the card's host: the core library
    (src/engine.cc, recordio.cc, storage.cc) and ``_mxtpu_ext``
    (src/py_ext.cc) built into build/ and used; the engine's ordering,
    parallel readers and error through both FFI backends; the arena's
    one pool shared by both backends and backing ``resource``'s temp
    space; then the record pipeline rerun with telemetry on.  No kernel
    of the six lies on this path (its counts are read around it).
    Returns (record, launches)."""
    from mxnet_tpu_torch import _native, engine, resource
    from mxnet_tpu_torch.ops import _build

    _kernel_launches(reset=True)
    t0 = time.perf_counter()
    ext = _native.get_ext()
    core = _native.lib_path()
    build_s = time.perf_counter() - t0
    if core is None or ext is None or \
            os.path.dirname(core) != _build.BUILD_DIR or \
            os.path.dirname(ext.__file__) != _build.BUILD_DIR:
        raise AssertionError(f"native runtime not built into build/: core "
                             f"{core}, ext {ext}")
    if _native.ffi_backend() != "cext" or not isinstance(
            engine.host_engine(), _native.NativeEngine) or \
            engine.host_engine()._be != "cext":
        raise AssertionError("the host engine does not run on _mxtpu_ext")
    out = {"build_s": build_s}
    for backend in ("ctypes", "cext"):
        out[backend] = _native_engine_check(backend)
    a = _native.NativeArena(backend="ctypes")
    b = _native.NativeArena(backend="cext")
    b.release_all()
    blk = a.alloc((1 << 20,), np.float32)
    a.free(blk)
    shared = b.pool_bytes()
    again = b.alloc((1 << 20,), np.float32)
    reused = again.ctypes.data == blk.ctypes.data
    b.free(again)
    b.release_all()
    space = resource.ResourceManager.get().request(
        "cpu", resource.ResourceRequest.kTempSpace)
    space.get_space((256, 256), np.float32)
    in_arena = space._buf.ctypes.data in resource._arena()._ptrs
    if shared != 4 << 20 or not reused or a.pool_bytes() != 0 or \
            not in_arena:
        raise AssertionError(f"arena: pooled {shared} across backends, "
                             f"reused {reused}, temp space in arena "
                             f"{in_arena}")
    log(f"[native] core {os.path.basename(core)} and "
        f"{os.path.basename(ext.__file__)} built or found in {build_s:.2f} "
        f"s; engine ctypes: {out['ctypes']['tasks_per_s']:.0f} tasks/s, "
        f"{out['ctypes']['readers_at_once']} readers at once; cext: "
        f"{out['cext']['tasks_per_s']:.0f} tasks/s, "
        f"{out['cext']['readers_at_once']} readers at once; a 4 MiB block "
        f"freed through ctypes pooled and reused through cext (one pool); "
        f"the temp space in the arena; {smi}")
    out["telemetry"] = _telemetry_rerun(smi, recs, img_s)
    launches = _kernel_launches()
    if any(launches.values()):
        raise AssertionError(f"phase_native launched {launches}")
    return out, launches


# ------------------------------------------------------------ phases 40-41
# MXNet's parameter-server training (bench.py:836-858's launch, at the
# ResNet-50 cell of bench.py:1985-2077): 2 workers on the card, CPU-only
# servers, a worker's batch 32 x 3 x 224 x 224 in fp32
DIST_BATCH = 32
DIST_STEPS = 12                  # phase 40's synchronous steps
DIST_TIMED_FROM = 2              # steps 1-2 save state: time steps 3-12
DIST_ASYNC_STEPS, DIST_ASYNC_BATCHES = 6, 2
DIST_OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
DIST_SEED = 1000                 # worker r's shard: a CUDA generator at 1000+r
# (max, median) over the parameters of ||a - b|| / ||b||: the workers'
# step 12 against one process summing both shards' gradients each step.
# The arithmetic and data are the same, but each process picks its own
# cuDNN algorithms (PERF.md section 7), and 12 momentum steps of a BN
# net compound a first-step difference of MODULE_TOL's size
DIST_TOL = (1e-2, 1e-3)
# bench.py:836-858's PS micro shape: 8 keys x 256 x 64, 20 rounds
DIST_MICRO_KEYS, DIST_MICRO_SHAPE, DIST_MICRO_ROUNDS = 8, (256, 64), 20
DIST_COORD_LEASE_S = 5.0         # phase 40: heartbeats every 1.7 s
DIST_ASYNC_LEASE_S = 600.0       # phase 41: the crash must not end a lease
DIST_DEAD_TIMEOUT_S = 2.0        # phase 41's get_num_dead_node staleness
DIST_TIMEOUT_S = 600

DIST_WORKER = r"""
# A worker of chip_smoke.py's phases 40-41, or, under MXTPU_ROLE=server,
# a parameter server: the server serves inside `import mxnet_tpu_torch`
# and exits there, before this script could touch the card.
import json, os, sys, time
T_START = time.time()
RANK = int(os.environ.get("MXTPU_RANK", "-1"))         # servers have none
MODE = os.environ.get("DIST_MODE", "sync")
RECOVERED = os.environ.get("MXTPU_KV_RECOVERY") == "1"
if MODE == "async" and RANK == 1 and not RECOVERED:
    # the first life dies at the coordinator poll after its 4th batch
    os.environ["MXTPU_FAULT_PLAN"] = "host_crash:crash_after:3"
import numpy as np
import mxnet_tpu_torch as mx
import torch
import chip_smoke as cs
from mxnet_tpu_torch import kvstore_server
from mxnet_tpu_torch.models import resnet

OUT = os.environ["DIST_OUT"]
TAG = "%s%d%s" % (MODE, RANK, "r" if RECOVERED else "")
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
mx.random.seed(RANK)              # each worker initialises differently


def save(name, tensors):
    np.savez(os.path.join(OUT, name + "_" + TAG + ".npz"),
             **{k: v.detach().contiguous().cpu().numpy()
                for k, v in tensors.items()})


steps = cs.DIST_STEPS if MODE == "sync" else cs.DIST_ASYNC_STEPS
batches = cs._dist_shard(RANK, steps if MODE == "sync"
                         else cs.DIST_ASYNC_BATCHES)
it = cs._resident_iter(batches, steps)
net = resnet.get_symbol(num_classes=1000, num_layers=50,
                        image_shape=(3, 224, 224))
mod = mx.mod.Module(net, context=mx.gpu(0))
mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
mod.init_params(initializer=mx.init.Xavier())
ex = mod._exec_group.execs[0]
names = list(mod._param_names)
weights = [ex.arg_dict[n] for n in names]
local = cs._bits_digest(weights)
cs._kernel_launches(reset=True)
mod.init_optimizer(kvstore="dist_" + MODE, optimizer="sgd",
                   optimizer_params=cs.DIST_OPT)
kv = mod._kvstore
res = {"rank": RANK, "recovered": RECOVERED, "t_start": T_START,
       "t_ready": time.time(), "num_workers": kv.num_workers,
       "rescale_grad": mod._optimizer.rescale_grad}
if MODE == "sync" and RANK == 0:
    with open(os.path.join(OUT, "optimizer.bin"), "wb") as f:
        f.write(kvstore_server.dumps_host(mod._optimizer))
digests, losses, comm, t_in, t_out, walls = [], [], [], [], [], []
dead = {"max": 0, "t": None}
if MODE == "async" and RANK == 0:
    import threading

    def watch():
        # worker 1 dies mid-run: its heartbeats stop and the servers say
        # so until its restart beats again
        while dead["max"] < 1:
            n = kv.get_num_dead_node(0, timeout=cs.DIST_DEAD_TIMEOUT_S)
            if n > dead["max"]:
                dead["max"], dead["t"] = n, time.time()
            time.sleep(0.25)

    threading.Thread(target=watch, daemon=True).start()


def cb(param):
    t_in.append(time.perf_counter())
    walls.append(time.time())
    n = param.nbatch
    # the weights here are those after step n: a step's pulls land at
    # the next forward (or the next parameter read)
    digests.append(cs._bits_digest(weights))
    p = ex.outputs[0]
    y = batches[n % len(batches)][1].long()
    losses.append(-p[torch.arange(len(y), device=p.device), y]
                  .clamp_min(1e-30).log().mean())
    if MODE == "sync" and n == 0:
        save("w0", dict(zip(names, weights)))
        save("g1", {k: ex.grad_dict[k] for k in names})
    if MODE == "sync" and n == 1:
        save("w1", dict(zip(names, weights)))
    comm.append(kv.comm_stats())
    with open(os.path.join(OUT, "steps_" + TAG + ".jsonl"), "a") as f:
        f.write(json.dumps({"step": n + 1, "t": walls[-1]}) + "\n")
    t_out.append(time.perf_counter())


mod.fit(it, num_epoch=1, batch_end_callback=cb)
mod.get_params()                   # lands the last step's pulls
digests.append(cs._bits_digest(weights))
res["launches"] = cs._kernel_launches()
res["digests"] = [str(int(d)) for d in digests]
res["local_digest"] = str(int(local))
res["losses"] = [float(v) for v in losses]
res["comm"] = comm
res["t_in"], res["t_out"], res["walls"] = t_in, t_out, walls
if MODE == "sync":
    save("w%d" % steps, dict(zip(names, weights)))
if MODE == "async" and RANK == 0:
    deadline = time.monotonic() + 180
    while time.monotonic() < deadline and dead["max"] < 1:
        time.sleep(0.25)
    res["dead_seen"], res["t_dead_seen"] = dead["max"], dead["t"]
kv.barrier()                       # both workers are members here
if RANK == 0:
    import urllib.request
    addr = os.environ["MXTPU_COORD_ADDR"]
    for path in ("cluster", "fleet"):
        with urllib.request.urlopen("http://%s/%s" % (addr, path),
                                    timeout=30) as r:
            with open(os.path.join(OUT, path + "_" + TAG + ".json"),
                      "wb") as f:
                f.write(r.read())
if MODE == "sync":
    # bench.py's PS micro shape on the same store and servers
    shape, ctx = cs.DIST_MICRO_SHAPE, mx.gpu(0)
    keys = list(range(1000, 1000 + cs.DIST_MICRO_KEYS))
    kv.init(keys, [mx.nd.ones(shape, ctx=ctx) for _ in keys])
    kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.01,
                                         rescale_grad=1.0))
    grads = [[mx.nd.ones(shape, ctx=ctx)] for _ in keys]
    outs = [mx.nd.zeros(shape, ctx=ctx) for _ in keys]
    kv.push(keys, grads)
    kv.pull(keys, outs)
    kv.barrier()
    tic = time.perf_counter()
    for _ in range(cs.DIST_MICRO_ROUNDS):
        kv.push(keys, grads)
        kv.pull(keys, outs)
    kv.wait_pulls()
    torch.cuda.synchronize()
    res["ps_micro_us"] = ((time.perf_counter() - tic)
                          / cs.DIST_MICRO_ROUNDS * 1e6)
    kv.barrier()
res["comm_end"] = kv.comm_stats()
with open(os.path.join(OUT, "result_" + TAG + ".json"), "w") as f:
    json.dump(res, f)
"""


def _dist_shard(rank, n):
    """Worker ``rank``'s ``n`` seeded batches on the card, ``(data,
    label)`` (a CUDA generator seeded per rank, so any process on the
    card remakes any worker's shard)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(DIST_SEED + rank)
    return [(torch.randn((DIST_BATCH, 3, 224, 224), generator=g,
                         device="cuda"),
             torch.randint(0, 1000, (DIST_BATCH,), generator=g,
                           device="cuda").float())
            for _ in range(n)]


def _bits_digest(tensors):
    """A 64-bit digest of the tensors' bits, taken on their device (no
    host sync): each 32-bit word times an odd multiplier of its
    position, summed mod 2**64, so any one word that differs changes
    it."""
    acc, off = None, 0
    for t in tensors:
        w = t.detach().contiguous().view(-1).view(torch.int32).to(
            torch.int64)
        pos = torch.arange(off, off + w.numel(), device=w.device,
                           dtype=torch.int64)
        off += w.numel()
        part = (w * (2 * pos + 1)).sum()
        acc = part if acc is None else acc + part
    return acc


def _dist_launch(mode, workers, servers, out, env_extra, args=()):
    """``python -m mxnet_tpu_torch.launch`` on ``DIST_WORKER``: the
    launcher's log and the servers' summaries.  Any worker or server
    that exits non-zero fails the phase; every process it started is
    killed on a timeout."""
    import signal

    repo = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(out, "dist_worker.py")
    with open(script, "w") as f:
        f.write(DIST_WORKER)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXTPU_", "DMLC_"))}
    env.update(PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p),
        DIST_MODE=mode, DIST_OUT=out, NVIDIA_TF32_OVERRIDE="0")
    env.update(env_extra)
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n",
           str(workers), "-s", str(servers), *args, "--launcher", "local",
           sys.executable, script]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=repo, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=DIST_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        raise AssertionError(f"dist_{mode}: no end in {DIST_TIMEOUT_S} s:\n"
                             f"{text[-4000:]}")
    wall = time.perf_counter() - t0
    with open(os.path.join(out, f"launch_{mode}.log"), "w") as f:
        f.write(text)
    if proc.returncode != 0:
        raise AssertionError(f"dist_{mode}: the launch exited "
                             f"{proc.returncode}:\n{text[-6000:]}")
    summaries = [json.loads(line.split(" ", 1)[1])
                 for line in text.splitlines()
                 if line.startswith("kvstore_server {")]
    if len(summaries) != servers or any(s["cuda_initialized"]
                                        for s in summaries):
        raise AssertionError(f"dist_{mode}: servers reported {summaries}")
    return text, summaries, wall


def _dist_result(out, tag):
    with open(os.path.join(out, f"result_{tag}.json")) as f:
        return json.load(f)


def _npz(out, name):
    with np.load(os.path.join(out, name + ".npz")) as z:
        return {k: z[k] for k in z.files}


def _host_update(out, names):
    """The servers' first update, applied here on the host: each key's
    two step-1 gradients summed (exact in either order), each server's
    share of the key updated by the port's updater from the optimizer
    worker 0 shipped (``kvstore_server._make_updater``); returns the
    largest |difference| from the workers' pulled step-1 weights and the
    number of parameters bit-equal."""
    from mxnet_tpu_torch import kvstore, kvstore_server

    with open(os.path.join(out, "optimizer.bin"), "rb") as f:
        body = f.read()
    w0, w1 = _npz(out, "w0_sync0"), _npz(out, "w1_sync0")
    g0, g1 = _npz(out, "g1_sync0"), _npz(out, "g1_sync1")
    ups = [kvstore_server._make_updater(body) for _ in range(2)]
    worst, equal = 0.0, 0
    for idx, name in enumerate(names):
        w = w0[name].reshape(-1).copy()
        g = (g0[name] + g1[name]).reshape(-1)
        for server, pkey, sl in kvstore.key_assignment(idx, w.size, 2):
            part = w[sl].copy()
            ups[server](pkey, g[sl].copy(), part)
            w[sl] = part
        got = w1[name].reshape(-1)
        worst = max(worst, float(np.abs(got - w).max()))
        equal += int(np.array_equal(got, w))
    return worst, equal


def _dist_reference(names, w0):
    """One process summing both shards' gradients each step, from worker
    0's initial weights ``w0``, through the Module's own updater with the
    same SGD (rescale 1 / 64): its weights after ``DIST_STEPS`` steps."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import resnet

    net = resnet.get_symbol(num_classes=1000, num_layers=50,
                            image_shape=(3, 224, 224))
    shards = [_dist_shard(r, DIST_STEPS) for r in range(2)]
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        mod = mx.mod.Module(net, context=mx.gpu(0))
        mod.bind(data_shapes=[("data", (DIST_BATCH, 3, 224, 224))],
                 label_shapes=[("softmax_label", (DIST_BATCH,))])
        mod.init_params(initializer=mx.init.Xavier(),
                        arg_params={k: torch.from_numpy(v) for k, v in
                                    w0.items()})
        mod.init_optimizer(kvstore=None, optimizer="sgd",
                           optimizer_params=dict(
                               DIST_OPT, rescale_grad=1.0 / (2 * DIST_BATCH)))
        ex = mod._exec_group.execs[0]
        for k in range(DIST_STEPS):
            mod.forward_backward(_batch(*shards[0][k]))
            g0 = {n: ex.grad_dict[n].clone() for n in names}
            mod.forward_backward(_batch(*shards[1][k]))
            for n in names:
                ex.grad_dict[n].add_(g0[n])
            mod.update()
        return {n: ex.arg_dict[n].detach().contiguous().cpu()
                for n in names}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = flags


def phase_dist_sync(smi):
    """Phase 40: ``dist_sync`` under the launcher, 2 workers x 2 servers
    (see the module docstring); returns ``(result, launches)``."""
    from mxnet_tpu_torch import _native
    from mxnet_tpu_torch.parallel.coordinator import CoordinatorService

    gc.collect()
    torch.cuda.empty_cache()
    if not _native.available():      # built once here, not by each worker
        raise AssertionError("the native host engine does not build")
    svc = _with_env({"MXTPU_FLEET_SCRAPE_S": "1"}, lambda: CoordinatorService(
        port=0, lease_s=DIST_COORD_LEASE_S).start())
    tmp = tempfile.TemporaryDirectory()
    out = tmp.name
    try:
        _, servers, wall = _dist_launch("sync", 2, 2, out, {
            "MXTPU_COORD_ADDR": svc.address,
            "MXTPU_TELEMETRY_HTTP_PORT": "0"})
        res = [_dist_result(out, f"sync{r}") for r in range(2)]
        with open(os.path.join(out, "cluster_sync0.json")) as f:
            cluster = json.load(f)
        with open(os.path.join(out, "fleet_sync0.json")) as f:
            fleet = json.load(f)
        # the param order the store keyed: Module's _param_names
        order = list(_npz(out, "g1_sync0"))
        # the workers' weights after every step, and after steps 1 and 12
        if res[0]["digests"] != res[1]["digests"] or \
                len(res[0]["digests"]) != DIST_STEPS + 1:
            raise AssertionError("dist_sync: the workers' weights part: "
                                 f"{res[0]['digests']} vs "
                                 f"{res[1]['digests']}")
        if res[0]["local_digest"] == res[1]["local_digest"] or \
                res[1]["local_digest"] == res[1]["digests"][0]:
            raise AssertionError("dist_sync: worker 1 did not start from "
                                 "worker 0's initial weights")
        for step in (1, DIST_STEPS):
            a, b = _npz(out, f"w{step}_sync0"), _npz(out, f"w{step}_sync1")
            bad = [n for n in order if not np.array_equal(a[n], b[n])]
            if bad:
                raise AssertionError(f"dist_sync: step {step}: the "
                                     f"workers' {bad[:3]} differ")
        worst, equal = _host_update(out, order)
        if equal != len(order):
            raise AssertionError(f"dist_sync: step 1 against the host "
                                 f"update: {equal} of {len(order)} "
                                 f"parameters bit-equal, worst {worst:g}")
        ref = _dist_reference(order, _npz(out, "w0_sync0"))
        final = {n: torch.from_numpy(v) for n, v in
                 _npz(out, f"w{DIST_STEPS}_sync0").items()}
        emax, ename, emed = _rel_errs(final, ref)
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        if emax > DIST_TOL[0] or emed > DIST_TOL[1]:
            raise AssertionError(f"dist_sync: step {DIST_STEPS} against "
                                 f"one process: max {emax:.3e} ({ename}), "
                                 f"median {emed:.3e}, tolerance {DIST_TOL}")
    finally:
        svc.stop()
        tmp.cleanup()
    launches = {k: res[0]["launches"][k] + res[1]["launches"][k]
                for k in res[0]["launches"]}
    if any(launches.values()):
        raise AssertionError(f"dist_sync launched {launches}")
    members = cluster["members"]
    if len(members) != 2 or cluster["generation"] != 0:
        raise AssertionError(f"dist_sync: /cluster {cluster}")
    if sorted(fleet["hosts"]) != sorted(members) or not all(
            h["scrape_ok"] for h in fleet["hosts"].values()):
        raise AssertionError(f"dist_sync: /fleet hosts {fleet['hosts']}")
    fams = [k for k, v in fleet["metrics"].items()
            if {s["labels"].get("host") for s in v["samples"]}
            >= set(members)]
    if "kvstore_push_total" not in fams:
        raise AssertionError(f"dist_sync: /fleet merged families {fams}")
    # timed steps 3-12: callback to callback, less each callback's own time
    lo = DIST_TIMED_FROM
    per = []
    for r in res:
        span = r["t_in"][-1] - r["t_out"][lo - 1]
        cbs = sum(o - i for i, o in zip(r["t_in"][lo:-1], r["t_out"][lo:-1]))
        c0, c1 = r["comm"][lo - 1], r["comm"][-1]
        n = DIST_STEPS - lo
        per.append({
            "step_ms": (span - cbs) / n * 1e3,
            "push_enqueue_ms": (c1["push_enqueue_s"] - c0["push_enqueue_s"])
            / n * 1e3,
            "pull_wait_ms": (c1["pull_wait_s"] - c0["pull_wait_s"]) / n * 1e3,
            "loop_waits": (c1["loop_waits"] - c0["loop_waits"]) / n,
            "push_mb": (c1["push_bytes"] - c0["push_bytes"]) / n / 1e6,
            "pull_mb": (c1["pull_bytes"] - c0["pull_bytes"]) / n / 1e6,
            "wire_mb_sent": (c1["wire_bytes_sent"] - c0["wire_bytes_sent"])
            / n / 1e6})
    step_ms = max(p["step_ms"] for p in per)
    result = {
        "img_s": 2 * DIST_BATCH / step_ms * 1e3, "step_ms": step_ms,
        "workers": per, "launch_wall_s": wall,
        "servers": [{k: s[k] for k in ("rank", "pushes", "pulls",
                                       "updates", "update_ms_mean",
                                       "update_s", "bytes_in",
                                       "bytes_out", "cuda_initialized")}
                    for s in servers],
        "host_update_bit_equal": equal, "params": len(order),
        "vs_one_process": {"max": emax, "max_param": ename,
                           "median": emed, "tol": DIST_TOL},
        "cluster": {"generation": cluster["generation"],
                    "members": sorted(members),
                    "step_skew_ratio": cluster["step_skew_ratio"],
                    "straggler": cluster["straggler"]},
        "fleet": {"hosts": sorted(fleet["hosts"]),
                  "merged_families": len(fams)},
        "dist_step_us_per_step_ps": res[0]["ps_micro_us"],
        "loss_first_last": [res[0]["losses"][0], res[0]["losses"][-1]]}
    log(f"[dist_sync] ResNet-50 b{DIST_BATCH}/worker x 2 workers, 2 servers, "
        f"fp32: {result['img_s']:.2f} img/s across both, step "
        f"{step_ms:.1f} ms (steps {lo + 1}-{DIST_STEPS}); per worker "
        + "; ".join(f"rank {r}: step {p['step_ms']:.1f} ms, push enqueue "
                    f"{p['push_enqueue_ms']:.2f} ms, pull wait "
                    f"{p['pull_wait_ms']:.1f} ms, {p['loop_waits']:.0f} "
                    f"loop waits, pushed {p['push_mb']:.1f} MB, pulled "
                    f"{p['pull_mb']:.1f} MB, sent {p['wire_mb_sent']:.1f} "
                    f"MB on the wire" for r, p in enumerate(per))
        + f" a step; {smi}")
    log(f"[dist_sync] servers: " + "; ".join(
        f"rank {s['rank']}: {s['updates']} updates, "
        f"{s['update_ms_mean']:.3f} ms mean, {s['update_s']:.2f} s total, "
        f"{s['bytes_in'] / 1e9:.2f} GB in, {s['bytes_out'] / 1e9:.2f} GB "
        f"out, cuda_initialized={s['cuda_initialized']}"
        for s in result["servers"]))
    log(f"[dist_sync] checks: weights bit-equal across workers after each "
        f"of {DIST_STEPS} steps; step 1 bit-equal to the host update "
        f"({equal}/{len(order)} params); step {DIST_STEPS} vs one process "
        f"max {emax:.3e} ({ename}) median {emed:.3e} (tol {DIST_TOL}); "
        f"/cluster generation {cluster['generation']} members "
        f"{sorted(members)} skew {cluster['step_skew_ratio']}; /fleet "
        f"{len(fams)} families merged over both hosts; launches "
        f"{json.dumps(launches)}")
    log(f"[dist_sync] PS micro (8 keys x 256 x 64, {DIST_MICRO_ROUNDS} "
        f"push+pull rounds, 2 workers x 2 servers): "
        f"dist_step_us_per_step_ps {res[0]['ps_micro_us']:.1f}; {smi}")
    log(f"[dist_sync] {json.dumps(result)}")
    return result, launches


def phase_dist_async(smi):
    """Phase 41: ``dist_async``, 2 workers x 1 server, worker 1 crashed
    and restarted (see the module docstring); returns ``(result,
    launches)``."""
    import datetime

    from mxnet_tpu_torch.parallel.coordinator import CoordinatorService

    gc.collect()
    torch.cuda.empty_cache()
    svc = CoordinatorService(port=0, lease_s=DIST_ASYNC_LEASE_S).start()
    tmp = tempfile.TemporaryDirectory()
    out = tmp.name
    try:
        text, servers, wall = _dist_launch(
            "async", 2, 1, out, {"MXTPU_COORD_ADDR": svc.address,
                                 "MXTPU_PS_HEARTBEAT_S": "0.5"},
            args=("--max-restarts", "1"))
        r0, r1 = (_dist_result(out, t) for t in ("async0", "async1r"))
        with open(os.path.join(out, "steps_async1.jsonl")) as f:
            first = [json.loads(line) for line in f]
    finally:
        svc.stop()
        tmp.cleanup()
    m = re.search(r"^(\S+ \S+) launch worker 1 exited with code (\d+); "
                  r"restarting", text, re.M)
    if m is None or m.group(2) != "137":
        raise AssertionError(f"dist_async: no crash and restart:\n"
                             f"{text[-4000:]}")
    t_crash = datetime.datetime.strptime(
        m.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp()
    if not r1["recovered"] or r0["dead_seen"] < 1:
        raise AssertionError(f"dist_async: recovered {r1['recovered']}, "
                             f"dead seen {r0['dead_seen']}")
    # the restarted worker pulled the servers' trained model: neither its
    # own initialisation nor the model the servers started from
    took = r1["digests"][0]
    if took in (r1["local_digest"], r0["digests"][0]):
        raise AssertionError("dist_async: the restarted worker did not "
                             "take the servers' model")
    loss = r0["losses"]
    falls = (loss[-1] + loss[-2]) < (loss[0] + loss[1])
    if not falls:
        raise AssertionError(f"dist_async: worker 0's loss {loss}")
    launches = {k: r0["launches"][k] + r1["launches"][k]
                for k in r0["launches"]}
    if any(launches.values()):
        raise AssertionError(f"dist_async launched {launches}")
    steps0 = r0["t_in"][-1] - r0["t_out"][0]
    result = {
        "img_s_worker0": DIST_BATCH * (DIST_ASYNC_STEPS - 1) / steps0,
        "step_ms_worker0": steps0 / (DIST_ASYNC_STEPS - 1) * 1e3,
        "restart_wall_s": r1["walls"][0] - t_crash,
        "restart_ready_s": r1["t_ready"] - t_crash,
        "first_life_steps": len(first),
        "dead_seen": r0["dead_seen"], "loss_worker0": loss,
        "loss_worker1_restarted": r1["losses"], "launch_wall_s": wall,
        "servers": [{k: s[k] for k in ("updates", "update_ms_mean",
                                       "cuda_initialized")}
                    for s in servers]}
    log(f"[dist_async] ResNet-50 b{DIST_BATCH}, 2 workers x 1 server: worker "
        f"0 {result['img_s_worker0']:.2f} img/s ({result['step_ms_worker0']:.1f}"
        f" ms a step); worker 1 crashed after {len(first)} steps at the "
        f"host_crash site and was restarted with MXTPU_KV_RECOVERY=1: its "
        f"first step {result['restart_wall_s']:.2f} s after the crash "
        f"(ready {result['restart_ready_s']:.2f} s), on the servers' model; "
        f"get_num_dead_node saw {r0['dead_seen']}; worker 0 loss "
        f"{loss[0]:.4f} -> {loss[-1]:.4f}; launches {json.dumps(launches)}; "
        f"{smi}")
    log(f"[dist_async] {json.dumps(result)}")
    return result, launches


def _kernel_launches(reset=False):
    """Each hand-written kernel's launch count (zeroed first when
    ``reset``), by its record's name."""
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import paged_attention as tpa
    from mxnet_tpu_torch.ops import residual_epilogue as tre

    if reset:
        fa.reset_launch_counts()
        for mod in (tpa, tre, rtc):
            mod.reset_launch_count()
    counts = {"paged_attention": tpa.launch_count(),
              "residual_epilogue": tre.launch_count(),
              "rtc": rtc.launch_count()}
    counts.update(fa.launch_counts())
    return counts


# -------------------------------------------------------------------- main
def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # fp32 products in full fp32 (the parity references assume it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuBLAS's deterministic workspace, which phase_survival's check
    # under torch.use_deterministic_algorithms needs (set before any
    # cuBLAS handle exists)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    smi, ptxas = phase_device()
    kern = phase_kernels()
    flash, flash_builds = phase_flash_kernels(ptxas)
    paged_build = paged_build_record(ptxas["paged_attention"])
    log(f"[build] paged_attention (registers and spills: split, combine): "
        f"{json.dumps(paged_build)}")
    # slice 16's C programs (phases 37-38) run here, while this process
    # holds little of the card: each child needs its own ~5 and ~20 GB,
    # which the cache of the later phases, fragmented by their live
    # tensors, would not leave free.  Each phase reads its own main
    # path's counts
    slice16 = {}
    _, slice16["c_predict"] = phase_c_predict(smi)
    _, slice16["c_api"] = phase_c_api(smi)
    # slice 17's workers (phases 40-41) each need ~7 GiB of their own:
    # next to 37-38, for the same reason
    slice17 = {}
    _, slice17["dist_sync"] = phase_dist_sync(smi)
    _, slice17["dist_async"] = phase_dist_async(smi)
    log(f"[slice17] hand-written kernel launches by phase: "
        f"{json.dumps(slice17)}")
    cfg, params = _params(seed=0)
    launches, tick = phase_serve(cfg, params)
    phase_parity(cfg, params)
    flash_launches, train = phase_train()
    # recompute runs the same cell: next to it, before the image phases
    # fill the allocator's cache
    remat_launches, remat = phase_remat(smi)
    # the profiled step is the same cell again
    prof, prof_launches = phase_profiler(smi)
    phase_train_resnet(smi)
    module = phase_module_resnet(smi)
    module_amp = phase_module_amp(smi, module)
    # FeedForward and the Custom head run phase_module_resnet's cell (50
    # GiB at batch 256): next to it, before later phases fragment the
    # allocator's cache.  The epilogue runs in FeedForward's score and
    # predict, no hand-written kernel under the Custom head
    ff, ff_state, ff_launches = phase_feedforward(smi)
    custom, custom_launches = phase_custom_op(smi, ff_state, ff["fit"])
    del ff_state
    epi, epi_launches = phase_predict()
    ckpt = phase_checkpoint()
    rtc_kernels, rtc_launches = phase_rtc(ckpt["logits"], ckpt["n_params"])
    phase_train_inception(smi)
    phase_module_alexnet(smi)
    zoo = phase_zoo_score(smi)
    # the LSTM LM's path runs no hand-written kernel: the counts stay 0
    lstm_launches = _kernel_launches(reset=True)
    phase_train_lstm(smi)
    phase_bucketing_lstm(smi)
    lstm_launches = _kernel_launches()
    log(f"[lstm] hand-written kernel launches in phases 12-13: "
        f"{json.dumps(lstm_launches)}")
    # training from RecordIO: the epilogue runs in score.py's sweeps only
    rec_launches = _kernel_launches(reset=True)
    # the records stay for phase_native's rerun with telemetry on
    rec_dir = tempfile.TemporaryDirectory()
    workdir = rec_dir.name
    recs = phase_records(smi, workdir)
    iters = phase_record_iter(smi, recs)
    train_rec = phase_train_records(smi, recs)
    module_rec = phase_module_records(smi, recs)
    phase_sequential(smi, workdir)
    rec_launches = _kernel_launches()
    step = train_rec["routes"]["resident"]["img_s"]
    log(f"[records] hand-written kernel launches in phases 14-18: "
        f"{json.dumps(rec_launches)}; iterator images/s over the captured "
        f"step's {step:.1f} (device-resident, same call): "
        + "; ".join(f"{k} {v / step:.3f}"
                    for k, v in iters["img_s"].items()) + f"; {smi}")
    want = module_rec["score"]["epilogue_launches"]
    if rec_launches["residual_epilogue"] != want or any(
            v for k, v in rec_launches.items()
            if k != "residual_epilogue"):
        raise AssertionError(f"phases 14-18 launched {rec_launches}, want "
                             f"{want} epilogue launches and no other")
    # row-sparse training and the kill/resume children run no hand-written
    # kernel; survival's Predictor runs the epilogue, remat the flash ones
    sparse_launches = _kernel_launches(reset=True)
    phase_sparse_mf(smi)
    phase_sparse_update(smi)
    sparse_launches = _kernel_launches()
    if any(sparse_launches.values()):
        raise AssertionError(f"phases 19-20 launched {sparse_launches}")
    survival = phase_survival(smi)
    phase_kill_resume(smi)
    # slice 13: int8 serving, the generation loops, the router, int8
    # inference; each phase reads its own main path's counts
    gc.collect()
    torch.cuda.empty_cache()
    slice13 = {}
    slice13["serve_int8"], dec16 = phase_serve_int8(cfg, params, smi)
    slice13["generate"] = phase_generate(cfg, dec16, smi)
    del dec16
    slice13["router"] = phase_router(cfg, params, smi)
    del params
    slice13["predict_int8"] = phase_predict_int8(smi)
    for tag, want in (("serve_int8", "paged_attention"),
                      ("router", "paged_attention"),
                      ("predict_int8", "residual_epilogue")):
        if not slice13[tag][want]:
            raise AssertionError(f"{tag}: {want} never launched")
    log(f"[slice13] hand-written kernel launches by phase: "
        f"{json.dumps(slice13)}")
    # slice 14: SSD-VGG16-300 training and detection, Faster R-CNN's
    # Proposal -> ROIPooling, LSTM-OCR over WarpCTC.  None of the six
    # kernels lies on these paths: their counts stay 0
    gc.collect()
    torch.cuda.empty_cache()
    det_launches = _kernel_launches(reset=True)
    _, ssd_params, ssd_data = phase_ssd_train(smi)
    phase_ssd_detect(smi, ssd_params, ssd_data)
    del ssd_params, ssd_data
    phase_rcnn(smi)
    phase_ocr(smi)
    det_launches = _kernel_launches()
    log(f"[detection] hand-written kernel launches in phases 31-34: "
        f"{json.dumps(det_launches)}")
    if any(det_launches.values()):
        raise AssertionError(f"phases 31-34 launched {det_launches}")
    # slice 15: the autotuner, then the health and perf planes, on the
    # LM's weights again
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params = _params(seed=0)
    _, tune_launches = phase_autotune(smi, cfg, params)
    gc.collect()
    torch.cuda.empty_cache()
    _, plane_launches = phase_planes(smi, cfg, params)
    del params
    log(f"[slice15] hand-written kernel launches: autotune "
        f"{json.dumps(tune_launches)}; planes {json.dumps(plane_launches)}")
    # slice 16: the native runtime and the data iterators' telemetry
    # (phases 37-38 ran after phase 2)
    _, slice16["native"] = phase_native(smi, recs, iters["img_s"])
    rec_dir.cleanup()
    if not slice16["c_predict"]["residual_epilogue"]:
        raise AssertionError("c_predict: the epilogue never launched")
    log(f"[slice16] hand-written kernel launches by phase: "
        f"{json.dumps(slice16)}")
    k = kern["bf16"]       # the serving path runs the kernel in bf16
    rec = {"name": "paged_attention", "route": "cuda", "source": PAGED_SRC,
           "replaces": PAGED_REPLACES, "launches": launches}
    rec.update(k)
    rec.update(paged_build)
    rec["tick_device_ms"] = tick["paged_ms"]
    rec["fp32"] = kern["fp32"]
    records = [rec]
    # the training path runs the flash kernels in bf16, causal
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        rec = {"name": name, "route": "cuda", "source": FLASH_SRC,
               "replaces": FLASH_REPLACES[name],
               "launches": flash_launches[name]}
        rec.update(flash[(torch.bfloat16, True)][name])
        rec.update(flash_builds[name])
        rec["roofline_share"] = rec["bound_ms"] / rec["ms"]
        rec["train_step_device_ms"] = train["flash_ms"][name]
        rec["launches_remat"] = remat_launches[name]
        rec["launches_remat_per_step"] = \
            remat["remat"]["flash_launches_per_step"][name]
        rec["fp32"] = flash[(torch.float32, True)][name]
        rec["non_causal"] = {"bf16": flash[(torch.bfloat16, False)][name],
                             "fp32": flash[(torch.float32, False)][name]}
        records.append(rec)
    # the inference path runs the epilogue in fp32 and bf16; the record's
    # times are per forward (the four tails), per-shape in "shapes"
    rec = {"name": "residual_epilogue", "route": "cuda", "source": EPI_SRC,
           "replaces": EPI_REPLACES, "launches": epi_launches}
    rec.update(epi["bf16"])
    rec["fp32"] = epi["fp32"]
    rec["launches_checkpoint"] = ckpt["launches"]
    rec["launches_module"] = module["epilogue_launches"]
    rec["launches_module_amp"] = module_amp["epilogue_launches"]
    rec["module_amp_dtypes"] = module_amp["score"]["dtypes"]
    rec["launches_zoo"] = sum(zoo["epilogue_launches"].values())
    rec["launches_zoo_by_model"] = zoo["epilogue_launches"]
    rec["launches_survival"] = survival["epilogue_launches"]
    records.append(rec)
    # Rtc compiles what the user writes: the record's times are those of
    # b_axpy (the full-width kernel), each user kernel's in "user_kernels"
    rec = {"name": "rtc", "route": "cuda", "source": RTC_SRC,
           "replaces": RTC_REPLACES, "launches": rtc_launches}
    rec.update({k: v for k, v in rtc_kernels["b_axpy"].items()
                if k not in ("grid", "block", "compile_ms")})
    rec["user_kernels"] = rtc_kernels
    records.append(rec)
    for rec in records:
        rec["launches_lstm"] = lstm_launches[rec["name"]]
        rec["launches_records"] = rec_launches[rec["name"]]
        rec["launches_sparse"] = sparse_launches[rec["name"]]
        rec["launches_feedforward"] = ff_launches[rec["name"]]
        rec["launches_custom_op"] = custom_launches[rec["name"]]
        rec["launches_profiler"] = prof_launches[rec["name"]]
        for tag, counts in (*slice13.items(), *slice16.items(),
                            *slice17.items()):
            rec[f"launches_{tag}"] = counts[rec["name"]]
        rec["launches_detection"] = det_launches[rec["name"]]
        rec["launches_autotune"] = tune_launches[rec["name"]]
        rec["launches_planes"] = plane_launches[rec["name"]]
    for rec in records[1:4]:
        rec["profiler_trace_device_ms"] = sum(
            t for k, t in prof["flash_ms"].items()
            if rec["name"].replace("bwd_", "") in k)
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
