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
MXNet's parameter-server training (``dist_sync``/``dist_async``
under the port's launcher), its core telemetry, training from and
checkpointing to an object store with a PyTorch layer in the graph, and
the device mesh (data and tensor parallel training, a tensor-parallel
decoder, sequence-parallel attention), pipeline and expert parallelism
(1F1B and GPipe over ``pipe``, the MoE LM over ``expert``) —
and holds each
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
   ``MXTPU_CONV_LAYOUT=NCHW``, 24 timed steps through ``step()`` and 24
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
   at batch 256 (TF32 off) 6 timed steps of each route (images/s, step
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
   scale halved and one overflow and one skip reported; at batch 256 6
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
   ``step()`` calls in fp32 and bf16, 16 timed steps through each route
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
   images/s over 6 calls with busy time and idle share, batch-1 fp32
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
   16 timed steps through each route with a profile (tokens/s, launch
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
   then 2,560 training and 256 val records (256 x 341 JPEG q90, label
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
   through ``FusedTrainer``, ``_survival_micro``'s keys (10 plain steps,
   10 with ``save_state(background=True)`` every 10, a synchronous
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
   seeded He-normal weights): ``fit`` over 2 + 5
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
27. int8 serving (``phase_serve_int8``; phases 27-29 run the LM's widths
   at ``LATE_LM_LAYERS`` layers): the served LM with int8 weights
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
   on the card behind ``start_router``, 64 requests spread over both (a
   scrape between the first 8 and the rest) and token-equal to a reference scheduler on the same weights, a drain
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
   gradients against the CPU, 40 steps (steps/s, the CTC loss first and
   last, the CTC backward's device ms and launch calls), the greedy
   decode's sequence accuracy on a held-out batch.  Phases 31-34 launch
   none of the six hand-written kernels (their counts are read around
   them: ``launches_detection``);
35. the autotuner (``phase_autotune``; phases 35-36 and phase 42's LM
   half run the LM's widths at ``LATE_LM_LAYERS`` layers): serving
   ``MFU_HEADLINE_CONFIG`` in bf16 (8 slots, 16-token pages, ``max_len`` 1024) under
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
37. the predict ABI (``phase_c_predict``, run with phase 38 and phase
   44's ``phase_amalgamation`` right after phase 2, while this process
   holds little of the card, since each starts a C program that needs
   its own memory; their clients run side by side, then each phase's
   work in this process, ``_side_by_side``): a C program
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
   6 steps over its own seeded shard on the card, with SGD (momentum)
   on the two CPU-only servers, and joins a coordinator this process
   runs (``MXTPU_COORD_ADDR``; its ``/cluster`` and ``/fleet``, with
   both workers' metric families merged, and the step-time skew are
   printed).  Checked: the two workers' weights bit-equal after every
   step (a 64-bit digest of their bits taken on the card each step, and
   the weights themselves after steps 1 and 6); after step 1 the pulled
   weights bit-equal to the servers' update applied here on the host
   (the port's updater, each server's share of each key) to the two
   workers' own saved step-1 gradients; after 6 steps the weights
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
   printed (``launches_dist_async``);
42. MXNet's core telemetry (``phase_core_telemetry``; its Module half,
   ``_core_module``, runs right after phase 25, beside
   ``phase_module_resnet``'s cell): ResNet-50 through ``Module.fit`` at
   b256 fp32 with the bucketed kvstore, ``Accuracy`` and a
   ``Speedometer``, 2 rounds of a 4-batch epoch with the families off
   then on after a warm-up epoch — the families' values as
   ``core_loop_counts`` predicts (the CPU tests hold both packages to
   it), the bucket families equal to a new store's plan, both stall
   sites, no compile after the warm-up, host syncs on the Speedometer's
   report batches only; the LM ``FusedTrainer`` at phase 36's cell, 2
   rounds of a 10-step ``fit`` epoch off then on — 10 x B samples, 10
   step observations, no compile, 0 host syncs a batch, L launches of
   each flash kernel a step, one step's launches held against the plain
   versions; the ResNet-50 ``Predictor`` at b32, 20 forwards — 20
   ``executor_forward_seconds`` observations, 80 epilogue launches each
   held against the plain version; ``dump_json`` and one
   ``LoggingReporter.report_once`` checked for those families; the step
   ms on and off, their ratio, tokens/s and images/s
   (``launches_core_telemetry``);
43. remote I/O and the plugins (``phase_remote_plugins``, run before
   phase 42 while phase 14's records exist): a loopback S3 double
   (``S3Double``: path-style, Range, HEAD, PUT, each request's SigV4
   signature recomputed with the port's signer) takes the 2,560
   records through ``open_uri("s3://...", "wb")``; ResNet-50 b32 fp32
   trains one epoch through ``Module.fit`` (phase 17's settings) over
   ``ImageRecordIter(path_imgrec="s3://...")`` with
   ``do_checkpoint("s3://...")`` and over the local file from the same
   weights, every batch's digest on the card bit-equal between the two
   (images/s, range GETs and bytes against the object's size, the
   iterator's construction s, PUTs and bytes of the checkpoint, the idle
   share of 4 more batches profiled); ``model.load_checkpoint`` from the store bit-equal to the
   Module's params; ``predict.create`` from the store, 5 forwards, 4
   epilogue launches each held against the plain version, logits
   bit-equal to an in-memory Predictor's; ``interop.save_params`` of the
   params at the size the shapes predict, read back bit-equal; the net
   with fc1 as ``TorchModule(nn.Linear(2048, 1000))`` through
   ``Module.fit`` against the native net (parameters within
   ``PLUGIN_TOL`` after step 1, then at step k in relative L2 within
   ``PLUGIN_SPREAD`` x k times what a 1-ulp move of the native net's fc1
   weights, up or down, gives, step ms, 0 host
   syncs a batch), ``TorchCriterion(
   CrossEntropyLoss(), grad_scale=32)``'s fc1 gradient against
   ``SoftmaxOutput``'s, ``opencv_plugin.imdecode`` of 32 records
   bit-equal to ``image.imdecode_np`` through cv2 or the port's own
   decode, whichever the machine has (``launches_remote_io``).
44. the port lint, the amalgamation and the Perl binding, in two parts:
   ``phase_amalgamation`` with phases 37-38 (its Perl child needs its
   own few GB of the card) builds the predict library from ``python -m
   mxnet_tpu_torch.amalgamate --predict`` with one ``g++`` line, loads
   it by ``ctypes`` and runs ResNet-50 b32 fp32 224² on ``dev_type`` 2,
   5 counted forwards, 4 epilogue launches each held against the plain
   version, every output bit-equal to the Python ``Predictor``'s; then
   builds ``mxnet_tpu_torch/bindings/perl`` against the port's predict
   library and runs ``MXNetTPU::Predictor`` once in a child perl on the
   same batch, bit-equal too (one line where the machine lacks Perl or
   MakeMaker) (``launches_amalgamation``); ``phase_port_lint``, last,
   runs ``python -m mxnet_tpu_torch.analysis --json`` in a child (exit
   0; findings and suppressions by family, s), each sync primitive of
   the lint's config and ``masked_select``, ``unique``,
   ``repeat_interleave``, ``torch.equal`` and pageable uploads on small
   card tensors under ``set_sync_debug_mode("warn")`` (it fails if the
   card flags one the static set lacks), and each host-sync entry
   point's witness: the earlier phase that shows its syncs, or a count
   here (the serving tick at 2 layers: 1 a tick; the checkpoint's
   capture and save, the host-only calls: 0) (``launches_port_lint``).
45. the device mesh (``phase_mesh``, run right after phases 40-41): (a)
   ``transformer_lm(**MFU_HEADLINE_CONFIG)`` at ``LATE_LM_LAYERS``
   layers, b8 x 1024, bf16 Adam,
   through ``FusedTrainer(mesh=create_mesh((1, 1), ("data", "model")),
   sharding_rules=megatron_rules())`` over a world-1 NCCL group: 3
   eager steps and a captured ``step_multi(3)`` held to the same trainer
   without a mesh from the same weights, the flash kernels' launches on
   the rank's heads counted against it and the first step's held
   against their plain versions, the step's wall as a ratio to the
   step without a mesh, its idle share and NCCL kernels; (b) two ranks
   sharing the card over gloo (``MESH_WORKER`` children) at the LM's
   widths cut to 2 layers: the (2, 1) and (1, 2) meshes for 3 steps
   against one process, ``KVDecoder`` 2-way over ``model`` against one
   process (fp32 greedy tokens equal over the prefill and 32 ticks; bf16
   logits along the dense greedy path), Ulysses and the ring against
   ``full_attention``, each collective gloo refuses on CUDA tensors
   recorded by name; (c) NCCL's refusal of two ranks on one card,
   quoted; (b)'s two pairs and (c)'s run at once
   (``launches_mesh``, ``launches_mesh_gloo``, ``mesh_world1``).
46. pipeline and expert parallelism (``phase_pipeline_moe``, right after
   phase 45; its two ranks, ``PIPE_WORKER``, share the card over gloo and
   import beside phase 45) at the LM's widths (d_model 2048, 16 heads,
   T 1024, vocab 32768): (a) ``train_pp.py``'s LM at 8 layers, 2 stages
   x 4 blocks, through ``make_pipeline_train_step`` (1F1B, M 4 x 2,
   fp32 SGD), 1 + 2 steps held to the sequential model in each rank
   (losses, the rank's stage's gradients), step ms, tokens/s, the
   exchange's bytes, peak memory, and
   ``pipeline_apply_tree``'s logits against the chain; (b) GPipe against
   1F1B peak memory at 2 layers, M 4 and 8; (c) ``train_moe.py``'s LM at
   2 layers on an ``expert`` mesh of 2, b4 x 1024, top-1 and top-2, 3
   SGD steps each, against a one-process dense oracle in fp64 with plain
   attention (NLL, aux, the first step's gradients, routing at every
   clear pick), the flash kernels' launches in each rank, and the flash
   kernels on step 1's q, k, v against fp64 attention; (d) bf16
   routing, kept tokens back
   and dropped ones 0 (``launches_pipeline_moe``).
47. ``Module`` and ``KVStore`` across ranks (``phase_collective``, right
   after phase 46; (a)'s ranks import beside phase 45): (a) phase 40's
   workers, seeds, batches and SGD (``DIST_WORKER``, ResNet-50 b32 a rank,
   fp32) launched ``-n 2 -s 0``, so ``kv.create("dist_sync")`` is the
   collective store over two ranks sharing the card (gloo), in one world
   that trains with ``MXTPU_SHARD_UPDATE=0`` then ``=1`` from the same
   seeds, ``DIST_STEPS`` steps each: both ranks' weights equal after every
   step, the two runs equal to the
   bit, the weights after steps 1 and ``DIST_STEPS`` held to phase 40's
   parameter-server weights (bit-equal, or within ``COLL_SPREAD`` times
   the fp32 oracle's distance from an fp64 oracle), host syncs a batch 0,
   optimizer state a rank half the replicated run's; step ms, the
   collectives' MB a step, rank 0's idle share, peak memory; (b) one
   process, ``Module`` over ``[gpu(0)]`` through ``dist_sync`` (the
   collective store at world 1) against ``device``, 3 steps bit-equal;
   (c) phase 45 (b)'s (2, 1) pair trains again under ``MXTPU_SENTINEL``
   with a fused CrossEntropy (after its run with the sentinel off): the
   metric's count over the global batch exactly, its value against the
   run's own per-step losses and one process's, each step's sentinel
   norm against one process, the flash kernels' launches a rank; (d)
   ``group2ctx`` on ``lstm_ptb.py``'s graph with every group on
   ``gpu(0)`` against the graph without groups, bit-equal, and a graph
   split between ``gpu(0)`` and ``cpu()`` against it unsplit, bit-equal
   (``launches_dp``).  Before the kernels line, a table of every phase's
   wall.

Any failure raises and exits nonzero.  The second-to-last lines are the
``{"kernels": [...]}`` record and the ``nvidia-smi`` name/power line;
the last line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py                 # needs one card
"""
from __future__ import annotations

import collections
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
# the LM's depth in phases 27-29, 35-36, 42 and 45 (a) (their widths
# are MFU_HEADLINE_CONFIG's): cut from 8 for the script's time limit; the
# main path's phases (3-5, 23, 26) keep all 8
LATE_LM_LAYERS = 4
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
# 8 warm-up steps, 24 timed steps through step() (bench.py times 60; cut
# for the script's time limit), step_multi at k 8 (3 calls), 8 batches
# through fit
RESNET_BATCH, RESNET_WARMUP, RESNET_STEPS, RESNET_K = 32, 8, 24, 8
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
# 0.9, kvstore "local"; 2 warm-up and 6 timed steps (bench.py: 12; cut
# for the script's time limit) through the eager
# Updater and through the bucketed update; parity at batch 32
MODULE_BATCH, MODULE_WARMUP, MODULE_STEPS = 256, 2, 6
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
# step_multi at k 8 against 8 step() calls, 16 timed steps a route
INCEPTION_BATCH, INCEPTION_K, INCEPTION_WARMUP = 32, 8, 3
INCEPTION_STEPS = 16
# AlexNet through Module (BASELINE.md:44-55): batch 256, fp32, 10 timed
# steps a route over one repeated batch
ALEXNET_BATCH, ALEXNET_WARMUP, ALEXNET_STEPS = 256, 2, 10
# the inference sweep of tools/benchmark_score.py:23-56, models at
# :62-63 (native image side each), batch 32, 6 timed calls
ZOO_MODELS = (("alexnet", 224), ("vgg", 224), ("googlenet", 224),
              ("inception-bn", 224), ("inception-v3", 299),
              ("inception-resnet-v2", 299), ("resnext-50", 224),
              ("resnet-50", 224), ("resnet-152", 224))
ZOO_BATCH, ZOO_CALLS = 32, 6
# card fp32 (TF32 off) logits against torch's CPU kernels, batch 1 (2
# before; cut for the script's time limit): the
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
LSTM_WARMUP, LSTM_STEPS = 3, 16
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
BUCKET_SENTENCES, BUCKETS = 800, (8, 16, 24, 32)
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
    _profile_events_check()
    return smi, ptxas


def _profile_events_check():
    """``_profile_events`` against ``prof.events()`` on a small profile of
    the card: the kernels, the host launch calls and a named range (what
    the phases read) must be the same events at the same times."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(256, 256, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            with record_function("chip_smoke.range"):
                x = torch.relu(x @ x.t() * 1e-3) + 1
        torch.cuda.synchronize()

    def read(events):
        return sorted(
            (e.name, str(e.device_type), e.time_range.start,
             e.time_range.end) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            or e.name in LAUNCH_CALLS or e.name == "chip_smoke.range")

    t0 = time.perf_counter()
    mine = read(_profile_events(prof))
    t1 = time.perf_counter()
    ref = read(prof.events())
    t2 = time.perf_counter()
    kernels = sum(e[1] == str(torch.autograd.DeviceType.CUDA) for e in ref)
    log(f"[device] profile reading: {len(ref)} events read ({kernels} on the "
        f"card) equal to prof.events()'s: {mine == ref}; "
        f"{(t1 - t0) * 1e3:.1f} ms against {(t2 - t1) * 1e3:.1f} ms")
    if mine != ref or not kernels:
        raise AssertionError(f"_profile_events: {len(mine)} events, "
                             f"prof.events() {len(ref)}")


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
def _params(seed=0, layers=None):
    """``MFU_HEADLINE_CONFIG`` (at ``layers`` layers, if given: its widths
    kept) and seeded random weights for it."""
    from mxnet_tpu_torch.models import transformer as tr

    cfg = tr.MFU_HEADLINE_CONFIG
    if layers is not None:
        cfg = dict(cfg, num_layers=layers)
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


_ProfRange = collections.namedtuple("_ProfRange", "start end")
_ProfEvent = collections.namedtuple("_ProfEvent",
                                    "name device_type time_range")


def _profile_events(prof):
    """``prof.events()``'s name, device type and time range (µs from the
    trace's start) of every event, read from the profiler's raw results:
    the same events, filtered and named as ``prof.events()`` names them,
    without building its ``FunctionEvent`` tree (which takes seconds of
    host time for each 10^4 events of an eager step's profile)."""
    from torch.autograd import profiler_util

    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    names, out = {}, []
    for e in res.events():
        raw = e.name()
        if profiler_util._filter_name(raw) or getattr(
                e, "is_hidden_event", lambda: False)():
            continue
        name = names.get(raw)
        if name is None:
            name = names[raw] = (torch._C._demangle(raw) if len(raw) > 1
                                 else raw)
        out.append(_ProfEvent(name, e.device_type(), _ProfRange(
            (e.start_ns() - t0) / 1000, (e.end_ns() - t0) / 1000)))
    return out


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
    for ev in _profile_events(prof):
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

    def _window_wait(self, window, site):
        self.waits.append(1)
        torch.cuda.set_sync_debug_mode(0)
        try:
            self.wait_one(window, site)
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
            lambda window, site: self._window_wait(window, site)
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
    """The timed route at batch 256: warm-up, 6 timed steps (host wall
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
                   for ev in _profile_events(prof)
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
    at batch 32, fp32 (TF32 off) and bf16, 6 timed forward + get_output
    calls, busy ms and idle share; fp32 logits at batch 1 against the
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
        small = {"data": (1, 3, side, side)}
        cpu = Predictor(symbol=net, arg_params=arg, aux_params=aux,
                        input_shapes=small, dev_type="cpu")
        card = Predictor(symbol=net, arg_params=arg, aux_params=aux,
                         input_shapes=small)
        cpu.forward(data=x[:1])
        card.forward(data=x[:1])
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
            + f"; batch-1 fp32 logits vs the CPU rel err {err:.3g} (tol {ZOO_TOL}); epilogue launches a "
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
REC_TRAIN, REC_VAL = 2560, 256
REC_SIDE = (256, 341)            # shorter side 256, 4:3
REC_QUALITY = 90
REC_BATCH = RESNET_BATCH
REC_SHAPE = (3, 224, 224)
REC_WARMUP, REC_TIMED = 2, 8    # batches of each iterator route
REC_CHECK_EVERY = 5              # the staging check's sampling
REC_MP_WORKERS = 4
REC_FIT_EPOCHS = 2
REC_K = 8                        # step_multi's steps a call
REC_RESIDENT_BATCHES = 24
REC_MODULE_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
REC_MONITOR_BATCHES, REC_MONITOR_EVERY = 21, 20
REC_STAGE_BATCHES = 4            # batches of the by-stage breakdown
SEQ_BATCH, SEQ_SAMPLES, SEQ_EPOCHS = 50, 2000, 2
MNIST_TRAIN, MNIST_TEST, MNIST_BATCH = 20000, 10000, 64   # 60000: cut
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
    ``MNIST_TRAIN`` train (MNIST's 60,000 cut for the script's time
    limit) and 10,000 test images of 28 x 28."""
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
# bench.py:577-642 (_survival_micro) runs 40 steps; cut for the time limit
SURV_STEPS, SURV_EVERY = 10, 10
KILL_SAMPLES, KILL_BATCH, KILL_EPOCHS, KILL_EVERY = 2048, 64, 2, 10
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
# started ahead of its turn: it trains once the go file exists
go = os.environ.get("KILL_GO")
while go and not os.path.exists(go):
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

    go = os.path.join(tmp, "go")

    def start(mode, ckdir, out):
        env = dict(os.environ, CHIP_SMOKE_REPO=repo, MXTPU_CKPT_DIR=ckdir,
                   MXTPU_CKPT_EVERY=str(KILL_EVERY),
                   CUBLAS_WORKSPACE_CONFIG=":4096:8")
        if mode == "resume":
            env["KILL_GO"] = go
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
    procs = {}
    try:
        d = {m: os.path.join(tmp, m) for m in ("straight", "victim",
                                               "preempt")}
        procs.update((m, start(m, d[m], os.path.join(tmp, m + ".npz")))
                     for m in d)
        # the resumed child needs only the victim's checkpoints: it starts
        # with the others and trains, beside them, once the victim is dead
        procs["resume"] = start("resume", d["victim"],
                                os.path.join(tmp, "resume.npz"))
        until(procs["victim"], "KILLME", "victim")
        procs["victim"].send_signal(_signal.SIGKILL)
        procs["victim"].wait(timeout=60)
        killed = procs["victim"].returncode
        published = ck.list_checkpoints(d["victim"])
        open(go, "w").close()
        until(procs["preempt"], "TERMME", "preempt")
        procs["preempt"].send_signal(_signal.SIGTERM)
        pout = finish(procs["preempt"], "preempt", rc=3)
        finish(procs["straight"], "straight")
        rout = finish(procs["resume"], "resume")
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
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
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
# He-normal weights): 2 warm-up and 5 timed batches of fit over a
# DataIter of device-resident batches, one epoch of 4 batches from
# numpy arrays, score and predict over 2 batches
FF_BATCH, FF_WARMUP, FF_STEPS = MODULE_BATCH, 2, 5
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
    as the head through ``FeedForward.fit`` (5 timed batches): step ms
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

        # the main path's run: every kernel count starts at 0 here.  The
        # router picks by the loads of its last scrape (1 s apart), so a
        # wave sent between two scrapes would go to one replica: the
        # first SLOTS requests go out, a scrape sees them admitted, then
        # the rest follow (the cached loads now differ, whatever the
        # host's speed)
        _kernel_launches(reset=True)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(32) as ex:
            first = [ex.submit(routed, p) for p in wave1[:SLOTS]]
            deadline = time.monotonic() + 120
            while not any(r[2].occupied + r[2].queue_depth for r in reps) \
                    and time.monotonic() < deadline:
                time.sleep(0.002)
            router.scrape_once()
            out1 = [f.result() for f in first] + list(
                ex.map(routed, wave1[SLOTS:]))
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
# 40 steps, cut from 200 for the script's time limit: the CTC loss
# falls from ~95.6 within its first 40 steps as well
OCR_STEPS = 40
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
    for ev in _profile_events(prof):
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
    from the same weights, then 40 steps (steps/s, the CTC loss at the
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
    # every candidate once, and the four re-timings of a winner the
    # search confirmed against the default (autotune_trials_total)
    if best["trials"] != len(us) or n_trials - len(us) not in (0, 4) or \
            won["impl"] != "cuda":
        raise AssertionError(f"search: {n_trials} trials ({best['trials']} "
                             f"recorded) for {len(us)} candidates, winner "
                             f"{won}")
    log(f"[autotune] paged search: {n_trials} trials ({len(us)} candidates"
        f"{', 4 re-timings to confirm a winner' if n_trials > len(us) else ''}"
        f") in {search_s:.2f} s "
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


class _Child:
    """A client started now and read later (``_client_run`` split in
    two), so that the C, C++ and Perl clients of phases 37, 38 and 44
    run side by side: ``result()`` is ``_client_run``'s (stdout,
    seconds), or its error.  Its output goes to files, and a thread
    notes when it exits."""

    def __init__(self, cmd, env, what, timeout=600):
        self.what, self.timeout = what, timeout
        self.free, self.total = torch.cuda.mem_get_info()
        self.out, self.err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, env=env, stdout=self.out,
                                     stderr=self.err)
        self.t1 = None
        self.watch = threading.Thread(target=self._watch, daemon=True)
        self.watch.start()

    def _watch(self):
        self.proc.wait()
        self.t1 = time.perf_counter()

    def wait(self):
        self.watch.join(max(self.t0 + self.timeout - time.perf_counter(), 0))
        if self.proc.poll() is None:
            self.proc.kill()
            self.watch.join()

    def result(self):
        self.wait()

        def read(f):
            f.seek(0)
            return f.read().decode(errors="replace")
        stdout, stderr = read(self.out), read(self.err)
        if self.proc.returncode != 0:
            raise AssertionError(
                f"{self.what} exited {self.proc.returncode} (the card had "
                f"{self.free / 2**30:.1f} of {self.total / 2**30:.1f} GiB "
                f"free at its start):\n{stdout[-3000:]}\n{stderr[-3000:]}")
        return stdout, self.t1 - self.t0


def _side_by_side(phases):
    """Runs generator phases whose first part builds and starts clients
    (yielding the ``_Child`` list) and whose second part reads them: every
    first part, then a wait for every client, then each second part in
    turn, so that no client runs beside this process's own timed work.
    Returns each phase's value in order."""
    children = []
    try:
        for gen in phases:
            children += next(gen)
    except BaseException:
        for child in children:
            child.proc.kill()
        raise
    for child in children:
        child.wait()
    out = []
    for gen in phases:
        try:
            next(gen)
        except StopIteration as stop:
            out.append(stop.value)
        else:
            raise AssertionError("a side-by-side phase yielded twice")
    return out


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
    A phase of ``_side_by_side``: its clients run beside phase 38's and
    phase 44's.  Returns (record, launches)."""
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
        client = _Child(
            [exe, sym_path, params, os.path.join(wd, "x.f32"), probs_path,
             "2", str(CPRED_CALLS), str(n), "3", "224", "224"],
            libinfo.client_env({**os.environ, **TF32_OFF}), CPRED_CLIENT)
        # what a fresh interpreter spends before MXPredCreate's own work
        probe = _Child([sys.executable, "-c", IMPORT_PROBE],
                       libinfo.client_env(), "import probe")
        yield [client, probe]
        stdout, run_s = client.result()
        if "PREDICT OK" not in stdout:
            raise AssertionError(f"C predict client: {stdout[-2000:]}")
        import_s = float(probe.result()[0].strip().splitlines()[-1])
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
        f"NVIDIA_TF32_OVERRIDE=0; beside the other C clients; {smi}")
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
    ``CAPI_ZERO_GRAD`` of the median gamma gradient's; and
    ``bindings/cpp/example_train.cc``, unchanged, against the same
    library (it binds the CPU: the binding's own check).  A phase of
    ``_side_by_side``: both clients run beside phase 37's and phase
    44's.  Returns (record, launches)."""
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
        client = _Child(
            [exe, paths["net.json"], paths["w.f32"], paths["x.f32"],
             paths["y.f32"], paths["g.f32"], "2", str(CAPI_STEPS),
             str(CAPI_LR), repr(rescale), str(n), "3", "224", "224"],
            env, CAPI_CLIENT)
        example = os.path.join(wd, "example_train")
        _client_build(_link_cmd(CPP_EXAMPLE, lib, example), CPP_EXAMPLE)
        ex_child = _Child([example], libinfo.client_env(), CPP_EXAMPLE)
        yield [client, ex_child]
        _kernel_launches(reset=True)
        stdout, run_s = client.result()
        flat = np.fromfile(paths["g.f32"], np.float32)
        ex_out, ex_s = ex_child.result()
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
        f"the client ran beside the other C clients; {smi}")
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
DIST_STEPS = 6                   # phase 40's synchronous steps
DIST_TIMED_FROM = 2              # steps 1-2 save state: time steps 3-6
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
# and exits there, before this script could touch the card.  Launched
# without servers (-s 0, phase 47 (a)) it trains through the collective
# dist_sync once for each MXTPU_SHARD_UPDATE of DIST_SHARDS, and also
# counts its host syncs a batch, its optimizer state bytes, its peak
# memory, the collectives' bytes and its device busy time over the
# timed steps.
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
COLLECTIVE = not os.environ.get("MXTPU_PS_SERVERS")
# phase 47 starts its world ahead of its turn: the ranks bind, initialise
# and meet, then train once the go file exists
GO = os.environ.get("DIST_GO")
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
steps = cs.DIST_STEPS if MODE == "sync" else cs.DIST_ASYNC_STEPS
batches = cs._dist_shard(RANK, steps if MODE == "sync"
                         else cs.DIST_ASYNC_BATCHES)
net = resnet.get_symbol(num_classes=1000, num_layers=50,
                        image_shape=(3, 224, 224))


def run(TAG):
    def save(name, tensors):
        np.savez(os.path.join(OUT, name + "_" + TAG + ".npz"),
                 **{k: v.detach().contiguous().cpu().numpy()
                    for k, v in tensors.items()})

    mx.random.seed(RANK)          # each worker initialises differently
    it = cs._resident_iter(batches, steps)
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
    t_ready = time.time()
    while GO and not os.path.exists(GO):
        time.sleep(0.05)
    res = {"rank": RANK, "recovered": RECOVERED, "t_start": T_START,
           "t_ready": t_ready, "t_go": time.time(),
           "num_workers": kv.num_workers,
           "rescale_grad": mod._optimizer.rescale_grad,
           "collective": kv.collective}
    sync, step_syncs, base, prof = None, [], [0], {}
    if COLLECTIVE:
        from mxnet_tpu_torch import telemetry
        telemetry.reset()
        telemetry.enable()
        sync = cs._SyncCounter()
    if MODE == "sync" and RANK == 0:
        with open(os.path.join(OUT, "optimizer.bin"), "wb") as f:
            f.write(kvstore_server.dumps_host(mod._optimizer))
    digests, losses, comm, t_in, t_out, walls = [], [], [], [], [], []
    dead = {"max": 0, "t": None}
    if MODE == "async" and RANK == 0:
        import threading

        def watch():
            # worker 1 dies mid-run: its heartbeats stop and the servers
            # say so until its restart beats again
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
        if sync is not None:
            # the step's own syncs (this callback's reads come after)
            step_syncs.append(sync.total() - base[0])
            if RANK == 0 and n == steps - 1 and "p" in prof:
                torch.cuda.synchronize()
                prof["wall"] = time.perf_counter() - prof["t0"]
                prof["p"].__exit__(None, None, None)
        # the weights here are those after step n: a step's pulls land at
        # the next forward (or the next parameter read)
        digests.append(cs._bits_digest(weights))
        p = ex.outputs[0]
        y = batches[n % len(batches)][1].long()
        losses.append(-p[torch.arange(len(y), device=p.device), y]
                      .clamp_min(1e-30).log().mean())
        # a parameter server's pulls land at the next forward: here the
        # weights lag one step; the collective store's are this step's
        lag = 0 if COLLECTIVE else 1
        if MODE == "sync" and n == 0:
            if not COLLECTIVE:
                save("w0", dict(zip(names, weights)))
            save("g1", {k: ex.grad_dict[k] for k in names})
        if MODE == "sync" and n == lag:
            save("w1", dict(zip(names, weights)))
        comm.append(kv.comm_stats())
        with open(os.path.join(OUT, "steps_" + TAG + ".jsonl"), "a") as f:
            f.write(json.dumps({"step": n + 1, "t": walls[-1]}) + "\n")
        if sync is not None:
            if RANK == 0 and n == cs.DIST_TIMED_FROM - 1:
                # rank 0's kernels over the timed steps: its busy time
                from torch.profiler import ProfilerActivity, profile
                torch.cuda.synchronize()
                prof["p"] = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                prof["p"].__enter__()
                prof["t0"] = time.perf_counter()
            base[0] = sync.total()
        t_out.append(time.perf_counter())

    if sync is None:
        mod.fit(it, num_epoch=1, batch_end_callback=cb)
    else:
        save("w0", dict(zip(names, weights)))     # worker 0's, broadcast
        torch.cuda.reset_peak_memory_stats()
        with sync:
            mod.fit(it, num_epoch=1, batch_end_callback=cb)
        eng = kv._fused
        reg = telemetry.get_registry()
        res.update({
            "step_syncs": step_syncs, "window_waits": len(sync.waits),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "state_bytes": eng.optimizer_state_bytes(),
            "shard_n": sorted({b.shard_n for b in eng._buckets}),
            "buckets": len(eng._buckets),
            "allreduce_bytes": reg.get("dist_allreduce_bytes_total").value(),
            "collective_bytes": {
                op: reg.get("executor_collective_bytes_total").value(op=op)
                for op in ("grad_allreduce", "kv_grad_shard",
                           "kv_param_allgather")}})
        if "wall" in prof:
            n_timed = steps - cs.DIST_TIMED_FROM
            kernel_ms, busy_ms = cs._kernel_busy(prof["p"], n_timed)
            res["profile"] = {"kernel_ms": kernel_ms, "busy_ms": busy_ms,
                              "wall_ms": prof["wall"] * 1e3 / n_timed}
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
    if RANK == 0 and os.environ.get("MXTPU_COORD_ADDR"):
        import urllib.request
        addr = os.environ["MXTPU_COORD_ADDR"]
        for path in ("cluster", "fleet"):
            with urllib.request.urlopen("http://%s/%s" % (addr, path),
                                        timeout=30) as r:
                with open(os.path.join(OUT, path + "_" + TAG + ".json"),
                          "wb") as f:
                    f.write(r.read())
    if MODE == "sync" and not COLLECTIVE:
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
    res["t_end"] = time.time()
    with open(os.path.join(OUT, "result_" + TAG + ".json"), "w") as f:
        json.dump(res, f)


TAG = "%s%d%s" % (MODE, RANK, "r" if RECOVERED else "")
if COLLECTIVE and os.environ.get("DIST_SHARDS"):
    # one world, each MXTPU_SHARD_UPDATE in turn from the same seeds;
    # the store reads the knob at its plan
    import gc
    for shard in os.environ["DIST_SHARDS"].split(","):
        os.environ["MXTPU_SHARD_UPDATE"] = shard
        run(TAG + "s" + shard)
        GO = None
        gc.collect()                   # the run's module and store
        torch.cuda.empty_cache()
    # the collectives on CUDA tensors, alone on the card
    with open(os.path.join(OUT, "probe_%d.json" % RANK), "w") as f:
        json.dump(cs._gloo_probe(RANK), f)
else:
    run(TAG)
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
    same SGD (rescale 1 / 64): ``{step: weights}`` after steps 1 and
    ``DIST_STEPS``."""
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
        out = {}
        for k in range(DIST_STEPS):
            mod.forward_backward(_batch(*shards[0][k]))
            g0 = {n: ex.grad_dict[n].clone() for n in names}
            mod.forward_backward(_batch(*shards[1][k]))
            for n in names:
                ex.grad_dict[n].add_(g0[n])
            mod.update()
            if k + 1 in (1, DIST_STEPS):
                out[k + 1] = {n: ex.arg_dict[n].detach().contiguous().cpu()
                              for n in names}
        return out
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = flags


def phase_dist_sync(smi):
    """Phase 40: ``dist_sync`` under the launcher, 2 workers x 2 servers
    (see the module docstring); returns ``(result, launches, weights)``:
    ``weights`` holds worker 0's weights at the start and after steps 1
    and ``DIST_STEPS`` and the one-process fp32 oracle's, which phase 47
    holds the collective store to."""
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
        refs = _dist_reference(order, _npz(out, "w0_sync0"))
        ps_weights = {"order": order, "oracle32": refs}
        for step in (0, 1, DIST_STEPS):
            ps_weights[step] = {n: torch.from_numpy(v) for n, v in
                                _npz(out, f"w{step}_sync0").items()}
        emax, ename, emed = _rel_errs(ps_weights[DIST_STEPS],
                                      refs[DIST_STEPS])
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
    # timed steps 3-6: callback to callback, less each callback's own time
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
    return result, launches, ps_weights


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


# -------------------------------------------------------------- phase 42
# MXNet's core telemetry (the trainer, engine, executor, kvstore, metric
# and Speedometer families) on the card: the LM step and the ResNet-50
# Module loop with the families off and on, the Predictor's forwards,
# dump_json and one LoggingReporter line
CORE_STEPS = 10                  # LM steps an epoch (one epoch a setting)
CORE_ROUNDS = 2                  # off/on epochs alternated, each model
CORE_MODULE_BATCHES = 4          # Module.fit batches of MODULE_BATCH
CORE_FREQUENT = 2                # the Speedometer's reporting period
CORE_PREDICT_CALLS = 20


def core_loop_counts(batches, batch, frequent, epochs=1, depth=2):
    """The deterministic values of the core families after ``epochs``
    epochs of ``Module.fit`` over ``batches`` full batches of ``batch``
    through a local kvstore, with the fused ``Accuracy`` and
    ``Speedometer(batch, frequent)`` (auto_reset), as both packages record
    them: ``{family: {label items: value}}`` in the shape of
    tests/test_torch_core_telemetry.py's ``_values``, which holds the two
    packages to it on the CPU.  The Speedometer reports at every
    ``frequent``-th batch after the first (a drain of the accuracy each),
    the epoch's end drains once more when batches came after the last
    report, and the async window waits once a batch past its ``depth``,
    the rest at the boundary."""
    reports = (batches - 1) // frequent
    drains = reports + (1 if (batches - 1) % frequent else 0)

    def nonzero(d):             # a count that never moved has no sample
        return {k: v for k, v in d.items() if v}

    counts = {
        "trainer_samples_total": {(("loop", "module"),):
                                  float(epochs * batches * batch)},
        "speedometer_samples_total": {(): float(epochs * reports * frequent
                                                * batch)},
        "kvstore_fused_update_seconds": {(("store", "local"),):
                                         epochs * batches},
        "metric_fused_update_total": {(("metric", "accuracy"),):
                                      float(epochs * batches)},
        "metric_host_sync_total": {(("metric", "accuracy"),):
                                   float(epochs * drains)},
        "executor_forward_seconds": {(): epochs * batches},
        "executor_backward_seconds": {(): epochs * batches},
        "trainer_host_stall_seconds": {
            (("site", "window"),): epochs * max(batches - depth, 0),
            (("site", "boundary"),): epochs * min(batches, depth)},
    }
    counts = {k: nonzero(v) for k, v in counts.items()}
    counts["engine_pipeline_depth"] = {(): 0.0}
    return counts


def _core_values(tm, names):
    """``core_loop_counts``'s shape from the registry: a counter's or a
    gauge's value, a histogram's observation count, by label items."""
    snap = tm.json_snapshot()["metrics"]
    return {n: {tuple(sorted(s["labels"].items())):
                s["count"] if "count" in s else s["value"]
                for s in snap[n]["samples"]} for n in names}


def _core_lm(smi, cfg):
    """The LM ``FusedTrainer`` at phase_planes' cell, one fit epoch of
    CORE_STEPS steps a setting, CORE_ROUNDS rounds of off then on; with
    the families on: CORE_STEPS x B samples, CORE_STEPS step observations,
    no compile, 0 host syncs a batch, L launches of each flash kernel a
    step; first, one step's flash launches held against the plain
    versions.  Returns (summary, flash launches of the on epochs)."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch import telemetry as tm
    from mxnet_tpu_torch.models import transformer as tr
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.trainer import FusedTrainer

    B, T, V, L = TRAIN_BATCH, cfg["seq_len"], cfg["vocab_size"], \
        cfg["num_layers"]
    tm.enable(False)
    mxrandom.seed(0)
    tk = FusedTrainer(tr.transformer_lm(**cfg), optimizer="adam",
                      optimizer_params={"lr": 1e-4},
                      dtype="bfloat16").init(data=(B, T),
                                             softmax_label=(B, T))
    # one step's launches, each against its plain version, at the state
    # where phase_profiler holds them (FLASH_STEP_TILE_TOL's calibration:
    # seed 0, its batch, the fifth step): a late step's dQ tiles cancel
    # further, and a tile's error relative to its norm grows with that
    rng = np.random.default_rng(0)
    d0 = rng.integers(0, V, (B, T)).astype(np.float32)
    l0 = rng.integers(0, V, (B, T)).astype(np.float32)
    for _ in range(4):
        tk.step(data=d0, softmax_label=l0)
    with _FlashRecorder() as rec:
        tk.step(data=d0, softmax_label=l0)
    checked = rec.check("core telemetry LM step")
    if checked != {k: L for k in fa.launch_counts()}:
        raise AssertionError(f"LM step checked {checked}")
    rng = np.random.default_rng(42)
    data = rng.integers(0, V, (B * CORE_STEPS, T)).astype(np.float32)
    label = rng.integers(0, V, (B * CORE_STEPS, T)).astype(np.float32)
    _lm_epoch(tk, data, label)                    # warm-up, families off
    walls = {"off": [], "on": []}
    flash = {k: 0 for k in fa.launch_counts()}
    for _ in range(CORE_ROUNDS):
        tm.enable(False)
        wall, _ = _lm_epoch(tk, data, label)
        walls["off"].append(wall)
        tm.reset()
        tm.enable()
        reg = tm.get_registry()
        compiles = reg.get("executor_compile_total").total()
        fa.reset_launch_counts()
        wall, sync = _lm_epoch(tk, data, label)
        got = fa.launch_counts()
        walls["on"].append(wall)
        per_batch = [b - a for a, b in zip(sync.marks, sync.marks[1:])]
        samples = reg.get("trainer_samples_total").value(loop="fused")
        steps = reg.get("trainer_step_seconds").count(loop="fused")
        if (len(sync.marks) != CORE_STEPS or any(per_batch)
                or sync.marks[0]):
            raise AssertionError(f"LM with the families on: host syncs "
                                 f"{sync.marks}")
        if samples != CORE_STEPS * B or steps != CORE_STEPS or \
                reg.get("executor_compile_total").total() != compiles:
            raise AssertionError(f"LM families: samples {samples}, steps "
                                 f"{steps}, compiles {compiles} -> "
                                 f"{reg.get('executor_compile_total').total()}")
        if got != {k: L * CORE_STEPS for k in got}:
            raise AssertionError(f"LM flash launches {got}")
        for k, v in got.items():
            flash[k] += v
    step_ms = reg.get("trainer_step_seconds").sum(loop="fused") \
        / CORE_STEPS * 1e3
    tm.enable(False)
    del tk
    gc.collect()
    torch.cuda.empty_cache()
    off = sum(walls["off"]) / (CORE_ROUNDS * CORE_STEPS) * 1e3
    on = sum(walls["on"]) / (CORE_ROUNDS * CORE_STEPS) * 1e3
    out = {"step_ms_off": off, "step_ms_on": on, "ratio": on / off,
           "tokens_per_s_off": B * T / off * 1e3,
           "tokens_per_s_on": B * T / on * 1e3,
           "dispatch_ms_on": step_ms, "tiles": rec.tiles}
    log(f"[core_telemetry] LM fit ({B} x {T}, bf16 Adam), {CORE_ROUNDS} "
        f"rounds of {CORE_STEPS} steps off then on: step {off:.3f} ms off, "
        f"{on:.3f} ms on (ratio {on / off:.4f}); tokens/s "
        f"{out['tokens_per_s_off']:.1f} off, {out['tokens_per_s_on']:.1f} "
        f"on; with the families on: trainer_samples_total {samples:.0f}, "
        f"{steps} trainer_step_seconds observations (mean dispatch "
        f"{step_ms:.3f} ms), compiles flat, 0 host syncs a batch; flash "
        f"launches {got} an epoch; one step's launches against the plain "
        f"versions {checked} (worst tile {json.dumps(rec.tiles)}); {smi}")
    return out, flash


def _core_module(smi):
    """ResNet-50 through ``Module.fit`` at phase_module_resnet's cell
    (b256, fp32, TF32 off, SGD lr 0.05 momentum 0.9, a local kvstore
    instance: the bucketed update) with ``Accuracy`` and a Speedometer,
    CORE_ROUNDS rounds of one epoch off then one on after a warm-up
    epoch; with the families on, the values ``core_loop_counts``
    predicts, the bucket families equal to the plan, both stall sites,
    no compile, and host syncs on the Speedometer's report batches only.
    Returns (summary, kernel launches of the on epochs)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import callback, io, metric, models
    from mxnet_tpu_torch import telemetry as tm

    net = models.get_symbol("resnet-50", num_classes=1000,
                            image_shape=(3, 224, 224))
    rs = np.random.RandomState(7)
    n = MODULE_BATCH * CORE_MODULE_BATCHES
    x = rs.uniform(0, 1, (n, 3, 224, 224)).astype(np.float32)
    y = rs.randint(0, 1000, n).astype(np.float32)
    kv = mx.kv.create("local")
    mod = mx.mod.Module(net, context=mx.gpu(0))
    names = ("trainer_samples_total", "speedometer_samples_total",
             "kvstore_fused_update_seconds", "metric_fused_update_total",
             "metric_host_sync_total", "executor_forward_seconds",
             "executor_backward_seconds", "trainer_host_stall_seconds",
             "engine_pipeline_depth")
    want = core_loop_counts(CORE_MODULE_BATCHES, MODULE_BATCH, CORE_FREQUENT)

    def epoch(first=False):
        it = io.NDArrayIter(x, y, batch_size=MODULE_BATCH)
        kw = dict(kvstore=kv, optimizer="sgd", optimizer_params=MODULE_OPT,
                  initializer=mx.init.Xavier()) if first else {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _SyncCounter() as sync:
            mod.fit(it, eval_metric=metric.Accuracy(), num_epoch=1,
                    batch_end_callback=[
                        callback.Speedometer(MODULE_BATCH, CORE_FREQUENT),
                        sync.mark], **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, sync

    tm.enable(False)
    epoch(first=True)                             # warm-up, families off
    walls = {"off": [], "on": []}
    launches = {k: 0 for k in _kernel_launches(reset=True)}
    for _ in range(CORE_ROUNDS):
        tm.enable(False)
        wall, _ = epoch()
        walls["off"].append(wall)
        tm.reset()
        tm.enable()
        _kernel_launches(reset=True)
        wall, sync = epoch()
        for k, v in _kernel_launches().items():
            launches[k] += v
        walls["on"].append(wall)
        got = _core_values(tm, names)
        reg = tm.get_registry()
        engine = kv._fused
        nb = engine.num_buckets
        nbytes = sum(b.nbytes for b in engine._buckets)
        bucket = (reg.get("kvstore_bucket_count").value(store="local"),
                  reg.get("kvstore_bucket_bytes").count(store="local"),
                  reg.get("kvstore_bucket_bytes").sum(store="local"))
        per_batch = [b - a for a, b in zip([0] + sync.marks, sync.marks)]
        report = [i for i in range(CORE_MODULE_BATCHES)
                  if i and i % CORE_FREQUENT == 0]
        if got != want:
            raise AssertionError(f"Module families {got}, predicted {want}")
        # the plan is built at the first push of a store, in the warm-up:
        # the on epochs keep it, and record no bucket family
        if bucket != (0.0, 0, 0.0) or not nb:
            raise AssertionError(f"bucket families {bucket} on a plan of "
                                 f"{nb} buckets")
        if reg.get("executor_compile_total").total():
            raise AssertionError("Module compiles after the warm-up")
        if any(s for i, s in enumerate(per_batch) if i not in report):
            raise AssertionError(f"Module host syncs a batch {per_batch}")
    # the bucket families at a plan's build: a new store, one step
    tm.reset()
    tm.enable()
    kv2 = mx.kv.create("local")
    mod.init_optimizer(kvstore=kv2, optimizer="sgd",
                       optimizer_params=MODULE_OPT, force_init=True)
    b0 = io.DataBatch(data=[mx.nd.array(x[:MODULE_BATCH], ctx=mx.gpu(0))],
                      label=[mx.nd.array(y[:MODULE_BATCH], ctx=mx.gpu(0))])
    mod.forward_backward(b0)
    mod.update()
    torch.cuda.synchronize()
    reg = tm.get_registry()
    plan = (reg.get("kvstore_bucket_count").value(store="local"),
            reg.get("kvstore_bucket_bytes").count(store="local"),
            reg.get("kvstore_bucket_bytes").sum(store="local"))
    engine = kv2._fused
    nb2 = engine.num_buckets
    nbytes2 = sum(b.nbytes for b in engine._buckets)
    kv_compiles = reg.get("executor_compile_total").value(kind="kv_update")
    tm.enable(False)
    if plan != (float(nb2), nb2, float(nbytes2)) or nb2 != nb or \
            nbytes2 != nbytes:
        raise AssertionError(f"bucket families {plan}; plan {nb2} buckets "
                             f"of {nbytes2} bytes")
    del mod, kv, kv2, x, y, b0
    gc.collect()
    torch.cuda.empty_cache()
    off = sum(walls["off"]) / (CORE_ROUNDS * CORE_MODULE_BATCHES) * 1e3
    on = sum(walls["on"]) / (CORE_ROUNDS * CORE_MODULE_BATCHES) * 1e3
    out = {"batch_ms_off": off, "batch_ms_on": on, "ratio": on / off,
           "img_s_off": MODULE_BATCH / off * 1e3,
           "img_s_on": MODULE_BATCH / on * 1e3, "buckets": nb,
           "bucket_bytes": nbytes, "families": {
               k: {"/".join(f"{a}={b}" for a, b in lk) or "-": v
                   for lk, v in d.items()} for k, d in got.items()},
           "report_syncs": per_batch, "kv_update_compiles": kv_compiles}
    log(f"[core_telemetry] ResNet-50 Module.fit (b{MODULE_BATCH}, fp32, "
        f"bucketed kvstore, Speedometer every {CORE_FREQUENT}), "
        f"{CORE_ROUNDS} rounds of {CORE_MODULE_BATCHES} batches off then "
        f"on: {off:.3f} ms a batch off, {on:.3f} ms on (ratio "
        f"{on / off:.4f}); images/s {out['img_s_off']:.2f} off, "
        f"{out['img_s_on']:.2f} on; families as predicted: "
        f"{json.dumps(out['families'])}; plan {nb} buckets of {nbytes} "
        f"bytes = kvstore_bucket_count/_bytes at a new store's plan "
        f"({kv_compiles:.0f} kv_update compiles there); host syncs a batch "
        f"{per_batch} (the Speedometer's reports read the accuracy); "
        f"launches {json.dumps(launches)}; {smi}")
    return out, launches


def _core_predict(smi):
    """The ResNet-50 Predictor at b32, fp32: CORE_PREDICT_CALLS forwards
    with the families on, one ``executor_forward_seconds`` observation
    each and 4 epilogue launches each, every launch held against the
    plain version.  Returns (summary, launches)."""
    from mxnet_tpu_torch import telemetry as tm
    from mxnet_tpu_torch.ops import residual_epilogue as tre

    net, arg, aux = _resnet50()
    x = np.random.default_rng(4).normal(
        size=(PREDICT_BATCH, 3, 224, 224)).astype(np.float32)
    p = _predictor(net, arg, aux)
    for _ in range(3):
        p.forward(data=x)
        p.get_output(0)
    tm.enable()
    reg = tm.get_registry()
    n0 = reg.get("executor_forward_seconds").count()
    tre.reset_launch_count()
    checked = 0
    with _EpilogueRecorder() as rec:
        for _ in range(CORE_PREDICT_CALLS):
            p.forward(data=x)
            out = p.get_output(0)
            checked += rec.check("core telemetry Predictor")
    launches = tre.launch_count()
    fwd = reg.get("executor_forward_seconds").count() - n0
    if fwd != CORE_PREDICT_CALLS or launches != 4 * CORE_PREDICT_CALLS or \
            checked != launches:
        raise AssertionError(f"Predictor: {fwd} forward observations, "
                             f"{launches} epilogue launches, {checked} "
                             f"checked in {CORE_PREDICT_CALLS} forwards")
    if out.shape != (PREDICT_BATCH, 1000) or not np.isfinite(out).all() \
            or not np.allclose(out.sum(1), 1.0, atol=1e-3):
        raise AssertionError(f"Predictor output {out.shape} not a softmax")
    mean_ms = reg.get("executor_forward_seconds").sum() / fwd * 1e3
    del p
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[core_telemetry] ResNet-50 Predictor b{PREDICT_BATCH} fp32, "
        f"{CORE_PREDICT_CALLS} forwards: executor_forward_seconds counted "
        f"{fwd} (mean dispatch {mean_ms:.3f} ms), {launches} epilogue "
        f"launches, each within its bound of the plain version; {smi}")
    counts = {k: 0 for k in _kernel_launches()}
    counts["residual_epilogue"] = launches
    return {"forwards": fwd, "dispatch_ms": mean_ms}, counts


def _core_exports(smi):
    """``dump_json`` of the registry as phase 42 left it (the LM's last on
    epoch, the Predictor's forwards) and one ``LoggingReporter`` line,
    each checked for the families."""
    from mxnet_tpu_torch import telemetry as tm

    with tempfile.TemporaryDirectory() as wd:
        path = tm.dump_json(os.path.join(wd, "metrics.json"))
        size = os.path.getsize(path)
        with open(path) as f:
            dumped = json.load(f)["metrics"]
    want = {"trainer_samples_total": float(CORE_STEPS * TRAIN_BATCH),
            "trainer_step_seconds": CORE_STEPS,
            "executor_forward_seconds": CORE_PREDICT_CALLS}
    got = {}
    for name in want:
        s = dumped[name]["samples"]
        got[name] = s[0].get("count", s[0].get("value")) if s else None
    if got != want:
        raise AssertionError(f"dump_json: {got}, want {want}")

    class _Lines(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    logger = logging.getLogger("chip_smoke.core_telemetry")
    logger.propagate = False
    handler = _Lines()
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        tm.LoggingReporter(logger=logger).report_once()
    finally:
        logger.removeHandler(handler)
    line = handler.lines[0] if handler.lines else ""
    for part in (f"trainer_samples_total{{loop=fused}}="
                 f"{CORE_STEPS * TRAIN_BATCH}",
                 f"trainer_step_seconds{{loop=fused}} n={CORE_STEPS} ",
                 f"executor_forward_seconds n={CORE_PREDICT_CALLS} "):
        if part not in line:
            raise AssertionError(f"LoggingReporter line lacks {part!r}: "
                                 f"{line[:400]}")
    tm.reset()
    tm.enable(False)
    log(f"[core_telemetry] dump_json: {len(dumped)} families, {size} bytes, "
        f"{json.dumps(got)}; LoggingReporter.report_once: one line of "
        f"{len(line)} characters: {line[:240]}...; {smi}")
    return {"families": len(dumped), "bytes": size}


def phase_core_telemetry(smi, cfg, module):
    """Phase 42, MXNet's core telemetry on the card (see the module
    docstring).  ``module`` is ``_core_module``'s result, run earlier
    beside phase_module_resnet's cell.  Returns (summary, launches of
    its main path runs)."""
    lm, flash = _core_lm(smi, cfg)
    pred, pred_launches = _core_predict(smi)
    exports = _core_exports(smi)
    counts = dict(module[1])
    for k, v in flash.items():
        counts[k] += v
    counts["residual_epilogue"] += pred_launches["residual_epilogue"]
    mod = module[0]
    log(f"[core_telemetry] step ms with the families on vs off: LM "
        f"{lm['step_ms_on']:.3f} vs {lm['step_ms_off']:.3f} (ratio "
        f"{lm['ratio']:.4f}, {lm['tokens_per_s_on']:.1f} tokens/s on); "
        f"ResNet-50 Module b{MODULE_BATCH} {mod['batch_ms_on']:.3f} vs "
        f"{mod['batch_ms_off']:.3f} (ratio {mod['ratio']:.4f}, "
        f"{mod['img_s_on']:.2f} images/s on); launches "
        f"{json.dumps(counts)}; {smi}")
    return {"lm": lm, "module": mod, "predict": pred,
            "exports": exports}, counts


# ---------------------------------------------------------------- phase 43
REMOTE_CREDENTIALS = ("AKIDCHIPSMOKE43", "chip/smoke+secret43", "eu-west-1",
                      "session-token-43")   # access key, secret, region, token
REMOTE_RECORDS = "s3://records/train.rec"
REMOTE_CKPT = "s3://checkpoints/resnet-50"
REMOTE_PREDICT_CALLS = 5
REMOTE_IDLE_BATCHES = 4          # batches of the profiled window
PLUGIN_BATCHES = 4               # Module.fit batches of each plugin net
# The TorchModule net against the native one, and TorchCriterion's fc1
# gradient against SoftmaxOutput's: fp32, TF32 off and cuDNN
# deterministic (the native net twice gives the same bits), so the nets
# part only by rounding: nn.Linear adds fc1's bias inside the GEMM,
# FullyConnected after it, and the criterion's log-softmax rounds
# otherwise than SoftmaxOutput's softmax.  One step leaves that at a few
# ulps (1e-5 is ~80 ulps of an O(1) value: a wrong transpose, a missed
# grad_scale or a second BatchNorm update moves it by 1e-3 or more).
# Later SGD steps at lr 0.1 amplify any rounding: on an H100, moving the
# native net's own fc1 weights by one ulp parts it from itself by 1.7e-6
# after 2 steps and 6.9e-5 after 8 on these records.  So step 1 is held
# to PLUGIN_TOL, and step k to PLUGIN_SPREAD x k times the 1-ulp spread
# of step k, which the phase measures beside it: the relative L2 norm
# of the parameters' difference over all of them, the larger of fc1's
# weights moved 1 ulp up and 1 ulp down.  The factor k: the torch layer
# rounds otherwise at every step, the 1-ulp move happens once, and a
# rounding made at step j grows no faster by step k than the move made
# at step 1.  PLUGIN_SPREAD covers how the spread varies with the start
# (the nets start from the s3:// fit, whose weights differ from run to
# run: the largest differences' ratio at step 2 ran from 0.24 to 6.6
# over five runs on an H100).
PLUGIN_TOL = 1e-5
PLUGIN_SPREAD = 4.0
OPENCV_RECORDS = 32


class S3Double:
    """A loopback S3 double in a thread: path-style ``/bucket/key``
    objects in memory, GET with ``Range``, HEAD and PUT.  Given
    ``credentials`` (access key, secret key, region, session token),
    every request's SigV4 signature is recomputed with the port's
    ``filesystem._sigv4_headers`` over the headers the request says it
    signed, a PUT's body hash is checked, and a request that differs is
    refused (403) and kept in ``bad``.  ``ranges=False`` answers a Range
    GET with the whole body (200), ``head=False`` refuses HEAD (405).
    ``log`` keeps ``(method, key, status, bytes in, bytes out, headers)``
    of every request."""

    _AUTH = re.compile(r"AWS4-HMAC-SHA256 Credential=([^/]+)/(\d{8})/"
                       r"([^/]+)/s3/aws4_request, SignedHeaders=([^,]+), "
                       r"Signature=([0-9a-f]{64})$")

    def __init__(self, credentials=None, ranges=True, head=True):
        import http.server

        self.credentials, self.ranges, self.head = credentials, ranges, head
        self.objects, self.log, self.bad = {}, [], []
        self.lock = threading.Lock()
        double = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_HEAD(self):
                double._serve(self, "HEAD")

            def do_GET(self):
                double._serve(self, "GET")

            def do_PUT(self):
                double._serve(self, "PUT")

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def endpoint(self):
        return "http://127.0.0.1:%d" % self.server.server_address[1]

    def env(self):
        """The environment that sends ``s3://`` here, signed when the
        double has credentials."""
        env = {"S3_ENDPOINT": self.endpoint}
        if self.credentials:
            ak, sk, region, token = self.credentials
            env.update(AWS_ACCESS_KEY_ID=ak, AWS_SECRET_ACCESS_KEY=sk,
                       AWS_REGION=region)
            if token:
                env["AWS_SESSION_TOKEN"] = token
        return env

    def requests(self, method=None):
        with self.lock:
            return [r for r in self.log if method in (None, r[0])]

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _signed(self, h, method, body):
        """Is the request signed as the port's signer signs it?"""
        import hashlib
        from urllib.parse import unquote

        from mxnet_tpu_torch.filesystem import _sigv4_headers

        ak, sk, region, token = self.credentials
        auth = h.headers.get("Authorization", "")
        m = self._AUTH.match(auth)
        amzdate = h.headers.get("x-amz-date", "")
        payload = h.headers.get("x-amz-content-sha256", "")
        if (not m or m.group(1) != ak or m.group(3) != region
                or m.group(2) != amzdate[:8]
                or h.headers.get("x-amz-security-token") != token):
            return False
        if method == "PUT" and payload != hashlib.sha256(body).hexdigest():
            return False
        own = ("host", "x-amz-date", "x-amz-content-sha256",
               "x-amz-security-token")
        names = [n for n in m.group(4).split(";") if n not in own]
        if any(h.headers.get(n) is None for n in names):
            return False
        want = _sigv4_headers(method, h.headers.get("Host", ""),
                              unquote(h.path.split("?", 1)[0]),
                              {n: h.headers[n] for n in names}, ak, sk,
                              region, amzdate, token, payload_hash=payload)
        return want["Authorization"] == auth

    def _serve(self, h, method):
        from urllib.parse import unquote

        key = unquote(h.path.split("?", 1)[0])
        n_in = int(h.headers.get("Content-Length") or 0)
        body = h.rfile.read(n_in) if n_in else b""
        out, status, extra = b"", 200, {}
        if self.credentials and not self._signed(h, method, body):
            status = 403
        elif method == "HEAD" and not self.head:
            status = 405
        elif method == "PUT":
            with self.lock:
                self.objects[key] = body
        else:
            with self.lock:
                data = self.objects.get(key)
            if data is None:
                status = 404
            else:
                out = data
                rng = h.headers.get("Range")
                if rng and self.ranges:
                    lo, hi = rng.split("=", 1)[1].split("-")
                    lo, hi = int(lo), min(int(hi), len(data) - 1)
                    out, status = data[lo:hi + 1], 206
                    extra["Content-Range"] = f"bytes {lo}-{hi}/{len(data)}"
        with self.lock:
            self.log.append((method, key, status, len(body),
                             len(out) if method == "GET" else 0,
                             dict(h.headers)))
            if status == 403:
                self.bad.append((method, key))
        if status >= 400:
            h.send_error(status)
            return
        h.send_response(status)
        for k, v in extra.items():
            h.send_header(k, v)
        h.send_header("Content-Length", str(len(out)))
        h.end_headers()
        if method == "GET":
            h.wfile.write(out)


def _batch_digest(batch, weights):
    """A batch's data and labels as three int64 sums on the card: the
    float32 bits, the bits weighted by position, the label bits (two's
    complement wraps, so any summation order gives the same value)."""
    x = batch.data[0].tensor.contiguous().view(torch.int32).reshape(-1)
    y = batch.label[0].tensor.contiguous().view(torch.int32).reshape(-1)
    x = x.to(torch.int64)
    return torch.stack([x.sum(), (x * weights[:x.numel()]).sum(),
                        y.to(torch.int64).sum()])


def _plain_iter(path):
    """ImageRecordIter over ``path`` without shuffle or random
    augmentation (center crops), so two runs give the same batches."""
    from mxnet_tpu_torch import image

    return image.ImageRecordIter(path, REC_SHAPE, REC_BATCH,
                                 preprocess_threads=os.cpu_count() or 1)


def _remote_fit(net, it, params, tag, smi, epoch_end=None):
    """One epoch of ``Module.fit`` (phase 17's settings) from ``params``
    over ``it`` stacked as ``PrefetchingIter -> DevicePrefetchIter``;
    each batch's digest kept on the card.  Returns (the module, row,
    digests)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import metric

    arg, aux = params
    weights = (torch.arange(REC_BATCH * int(np.prod(REC_SHAPE)),
                            device=CARD, dtype=torch.int64) % 65521) + 1
    digests = []

    def digest(param):
        digests.append(_batch_digest(param.locals["data_batch"], weights))

    mod = mx.mod.Module(net)
    acc = metric.Accuracy()
    pipe = _stacked(it)
    with _ConsumerSyncs() as sync:
        t0 = time.perf_counter()
        mod.fit(pipe, num_epoch=1, kvstore="device", optimizer="sgd",
                optimizer_params=dict(REC_MODULE_OPT),
                arg_params={k: v.copy() for k, v in arg.items()},
                aux_params={k: v.copy() for k, v in aux.items()},
                eval_metric=acc, batch_end_callback=[digest, sync.mark],
                epoch_end_callback=epoch_end)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_batch, _ = _per_batch(sync.marks)
    row = {"img_s": len(digests) * REC_BATCH / wall, "wall_s": wall,
           "batches": len(digests),
           "syncs_per_batch": sum(per_batch) / max(len(per_batch), 1),
           "accuracy": acc.get()[1]}
    log(f"[remote_io] Module.fit ResNet-50 b{REC_BATCH} fp32 over {tag}: "
        f"{row['batches']} batches, {row['img_s']:.1f} img/s, host syncs "
        f"a batch {row['syncs_per_batch']:.1f}, train accuracy "
        f"{row['accuracy']:.4f}; {smi}")
    if any(per_batch):
        raise AssertionError(f"{tag}: host syncs between batches "
                             f"{per_batch}")
    return mod, row, torch.stack(digests)


def _fit_idle(mod, it, n, tag, smi):
    """The idle share of ``n`` more ``Module.fit`` batches of ``mod`` over
    ``it`` (a CUDA-only profile of a short window: the profiler's events
    of a whole epoch take minutes to read back)."""
    from torch.profiler import ProfilerActivity, profile

    pipe = _Limited(_stacked(it), n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mod.fit(pipe, num_epoch=1, kvstore="device", optimizer="sgd",
                optimizer_params=dict(REC_MODULE_OPT))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _, busy = _kernel_busy(prof, 1)
    idle = 1 - busy / wall_ms
    log(f"[remote_io] Module.fit over {tag}, {n} batches profiled: device "
        f"busy {busy:.1f} ms in {wall_ms:.1f}, idle share {idle:.4f}; {smi}")
    return idle


def _remote_io(smi, recs, s3, workdir):
    """Phase 43's store half; returns its numbers."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import (callback, filesystem, interop, model,
                                 models, predict)
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.ops import residual_epilogue as tre

    out = {}
    # 1. the records into the store through open_uri
    local = recs["train"]
    with open(local, "rb") as f:
        blob = f.read()
    t0 = time.perf_counter()
    with filesystem.open_uri(REMOTE_RECORDS, "wb") as f:
        f.write(blob)
    out["upload_s"] = time.perf_counter() - t0
    key = REMOTE_RECORDS[len("s3:/"):]
    if s3.objects.get(key) != blob:
        raise AssertionError("the uploaded records differ from the file")
    # 2. the iterators: the store's object read once at construction
    n0 = len(s3.log)
    t0 = time.perf_counter()
    it_s3 = _plain_iter(REMOTE_RECORDS)
    out["ctor_s3_s"] = time.perf_counter() - t0
    reads = s3.log[n0:]
    gets = [r for r in reads if r[0] == "GET"]
    out["gets"], out["heads"] = len(gets), len(reads) - len(gets)
    out["bytes_read"] = sum(r[4] for r in gets)
    t0 = time.perf_counter()
    it_local = _plain_iter(local)
    out["ctor_local_s"] = time.perf_counter() - t0
    if not len(it_s3.records) == len(it_local.records) == REC_TRAIN:
        raise AssertionError(f"{len(it_s3.records)} records over s3, "
                             f"{len(it_local.records)} local")
    log(f"[remote_io] {REC_TRAIN} records ({len(blob)} bytes) uploaded "
        f"through open_uri in {out['upload_s']:.3f} s; ImageRecordIter "
        f"over s3:// built in {out['ctor_s3_s']:.3f} s ({out['heads']} "
        f"HEAD, {out['gets']} range GETs, {out['bytes_read']} bytes read "
        f"of the object's {len(blob)}), over the local file in "
        f"{out['ctor_local_s']:.3f} s; {smi}")
    if out["bytes_read"] != len(blob):
        raise AssertionError(f"read {out['bytes_read']} bytes of "
                             f"{len(blob)}")
    # 3. Module.fit over each, from one set of weights; the store's run
    # checkpoints into the store at the epoch's end
    mx.random.seed(0)
    net = models.get_symbol("resnet-50", num_classes=1000)
    init_mod = mx.mod.Module(net)
    init_mod.bind(data_shapes=it_local.provide_data,
                  label_shapes=it_local.provide_label)
    init_mod.init_params(mx.init.Xavier(rnd_type="gaussian",
                                        factor_type="in", magnitude=2))
    arg0, aux0 = init_mod.get_params()
    params = ({k: v.copy() for k, v in arg0.items()},
              {k: v.copy() for k, v in aux0.items()})
    # a short fit first, so that neither timed route pays the card's
    # first convolutions (cuDNN's algorithm choice, the allocator)
    init_mod.fit(_Limited(_stacked(_plain_iter(local)), 3), num_epoch=1,
                 kvstore="device", optimizer="sgd",
                 optimizer_params=dict(REC_MODULE_OPT))
    del init_mod
    ckpt = {}
    save = callback.do_checkpoint(REMOTE_CKPT)

    def checkpoint(epoch, symbol, arg, aux):
        n0 = len(s3.log)
        t0 = time.perf_counter()
        save(epoch, symbol, arg, aux)
        ckpt["put_s"] = time.perf_counter() - t0
        puts = [r for r in s3.log[n0:] if r[0] == "PUT"]
        ckpt["puts"], ckpt["put_bytes"] = len(puts), sum(r[3] for r in puts)

    mod, out["fit_s3"], dig_s3 = _remote_fit(
        net, it_s3, params, REMOTE_RECORDS, smi, epoch_end=checkpoint)
    local_mod, out["fit_local"], dig_local = _remote_fit(
        net, it_local, params, "the local file", smi)
    out["idle_share"] = _fit_idle(local_mod, _plain_iter(REMOTE_RECORDS),
                                  REMOTE_IDLE_BATCHES, REMOTE_RECORDS, smi)
    del local_mod
    equal = dig_s3.shape == dig_local.shape and torch.equal(dig_s3,
                                                            dig_local)
    # the s3 fit's wall holds the epoch-end checkpoint's upload
    bare = out["fit_s3"]["batches"] * REC_BATCH / (
        out["fit_s3"]["wall_s"] - ckpt["put_s"])
    log(f"[remote_io] the {dig_s3.shape[0]} batches over s3:// bit-equal "
        f"to the local file's: {equal}; images/s s3 / local "
        f"{out['fit_s3']['img_s'] / out['fit_local']['img_s']:.4f} "
        f"({bare / out['fit_local']['img_s']:.4f} less the checkpoint's "
        f"upload); the checkpoint: {ckpt['puts']} PUTs, "
        f"{ckpt['put_bytes']} bytes in {ckpt['put_s']:.3f} s; {smi}")
    if not equal or dig_s3.shape[0] != REC_TRAIN // REC_BATCH:
        raise AssertionError("the batches over s3:// differ from the "
                             "local file's")
    if ckpt["puts"] != 2:
        raise AssertionError(f"the checkpoint took {ckpt['puts']} PUTs")
    out["ckpt"] = ckpt
    # 4. back from the store
    arg_m, aux_m = mod.get_params()
    n0 = len(s3.log)
    t0 = time.perf_counter()
    sym2, arg2, aux2 = model.load_checkpoint(REMOTE_CKPT, 1)
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    got = [r for r in s3.log[n0:] if r[0] == "GET"]
    out["load_gets"], out["load_bytes"] = len(got), sum(r[4] for r in got)
    same_sym = sym2.tojson() == mod.symbol.tojson()
    differ = sorted(k for a, b in ((arg2, arg_m), (aux2, aux_m))
                    for k in set(a) | set(b)
                    if k not in a or k not in b or not torch.equal(
                        a[k].tensor, b[k].tensor.to(a[k].tensor.device)))
    if not same_sym or differ:
        raise AssertionError(f"the checkpoint read back from s3:// differs "
                             f"from the Module's: symbol equal {same_sym}, "
                             f"params that differ {differ[:8]}")
    x = np.random.default_rng(43).normal(
        size=(REC_BATCH,) + REC_SHAPE).astype(np.float32)
    shapes = {"data": (REC_BATCH,) + REC_SHAPE}
    remote = predict.create(REMOTE_CKPT, 1, shapes)
    mem = predict.Predictor(symbol=mod.symbol, arg_params=arg_m,
                            aux_params=aux_m, input_shapes=shapes)
    n0, checked = tre.launch_count(), 0
    with _EpilogueRecorder() as rec:
        for _ in range(REMOTE_PREDICT_CALLS):
            remote.forward(data=x)
            logits = remote.get_output(0)
            checked += rec.check("predict.create from s3://")
    launches = tre.launch_count() - n0
    mem.forward(data=x)
    same = np.array_equal(logits, mem.get_output(0))
    out["predict_launches"] = launches
    log(f"[remote_io] load_checkpoint from s3:// in {out['load_s']:.3f} s "
        f"({out['load_gets']} GETs, {out['load_bytes']} bytes), params "
        f"bit-equal to the Module's; predict.create from s3:// b{REC_BATCH}"
        f" fp32: {REMOTE_PREDICT_CALLS} forwards, {launches} epilogue "
        f"launches each within its bound of the plain version, logits "
        f"bit-equal to the in-memory Predictor's: {same}; {smi}")
    if launches != 4 * REMOTE_PREDICT_CALLS or checked != launches \
            or not same or logits.shape != (REC_BATCH, 1000):
        raise AssertionError(f"predict.create: {launches} launches, "
                             f"{checked} checked, logits equal {same}")
    del remote, mem
    # 5. the reference's binary format, written locally
    path = os.path.join(workdir, "resnet-50-0001.params")
    interop.save_params(path, arg_m, aux_m)
    items = [("arg:" + k, v) for k, v in arg_m.items()] + \
        [("aux:" + k, v) for k, v in aux_m.items()]
    want = 24 + 8 + sum(4 + 4 * v.ndim + 12 + v.size * 4 + 8 + len(n)
                        for n, v in items)
    size = os.path.getsize(path)
    back = nd.load(path)
    equal = size == want and sorted(back) == sorted(n for n, _ in items) \
        and all(torch.equal(back[n].tensor, v.tensor.to(back[n].tensor.device))
                for n, v in items)
    out["params_bytes"] = size
    log(f"[remote_io] interop.save_params: {size} bytes (predicted from "
        f"the shapes {want}), nd.load bit-equal: {equal}; {smi}")
    if not equal:
        raise AssertionError("save_params: size or values differ")
    return out, mod


def _plugin_fits(smi, mod, local):
    """ResNet-50 b32 fp32 with fc1 as ``TorchModule(nn.Linear(2048,
    1000))`` against the native net through ``Module.fit`` from the same
    weights on the same resident batches (cuDNN deterministic); the
    native net again (for its own determinism and a warm step time) and
    with fc1's weights moved by one ulp (how far fp32 rounding alone
    carries these steps); the same net's fc1 gradient under
    ``TorchCriterion(CrossEntropyLoss(), grad_scale=32)`` against
    ``SoftmaxOutput``'s."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch import symbol as sym
    from mxnet_tpu_torch.plugins import torch_plugin as tp

    net = mod.symbol
    arg, aux = mod.get_params()
    fc = net.get_internals()["fc1_output"]
    flat = fc.get_children()[0]
    n_out, n_in = arg["fc1_weight"].shape
    linear = torch.nn.Linear(n_in, n_out)
    mid = tp.register_module(linear)
    tnet = sym.SoftmaxOutput(sym.TorchModule(
        flat, sym.Variable("fc1_weight", shape=(n_out, n_in)),
        sym.Variable("fc1_bias", shape=(n_out,)), module_id=mid,
        name="fc1_torch"), name="softmax")
    batches = []
    for b in _stacked(_plain_iter(local)):
        batches.append((b.data[0].tensor.clone(), b.label[0].tensor.clone()))
        if len(batches) == PLUGIN_BATCHES:
            break
    w = arg["fc1_weight"].tensor
    ulps = {f"native, fc1 {sign}1 ulp": dict(arg, fc1_weight=nd.NDArray(
        torch.nextafter(w, torch.full_like(w, math.copysign(math.inf, e)))))
        for sign, e in (("+", 1.0), ("-", -1.0))}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    rows, ref = {}, []

    def fit(tag, graph, start):
        m = mx.mod.Module(graph)
        diffs, norms = [], []

        def step(param):
            now = m.get_params()[0]
            if tag == "native":
                ref.append({k: v.tensor.clone() for k, v in now.items()})
            else:
                base = ref[len(diffs)]
                d = [v.tensor - base[k] for k, v in now.items()]
                diffs.append(torch.stack([t.abs().max() for t in d]).max())
                norms.append(torch.stack([t.square().sum() for t in d]).sum()
                             .sqrt() / torch.stack([
                                 t.square().sum() for t in base.values()])
                             .sum().sqrt())

        with _ConsumerSyncs() as sync:
            m.fit(_resident_iter(batches, PLUGIN_BATCHES), num_epoch=1,
                  kvstore="device", optimizer="sgd",
                  optimizer_params=dict(REC_MODULE_OPT),
                  arg_params={k: v.copy() for k, v in start.items()},
                  aux_params={k: v.copy() for k, v in aux.items()},
                  batch_end_callback=[step, sync.mark])
            torch.cuda.synchronize()
        per_batch, _ = _per_batch(sync.marks)
        if any(per_batch):
            raise AssertionError(f"{tag}: host syncs between batches "
                                 f"{per_batch}")
        rows[tag] = {"step_ms": float(np.median(np.diff(sync.stamps)[1:])
                                      * 1e3),
                     "syncs_per_batch": sum(per_batch) / len(per_batch),
                     "diff": (torch.stack(diffs).tolist() if diffs
                              else None),
                     "norm": (torch.stack(norms).tolist() if norms
                              else None)}

    try:
        # the step ms compared are those of the two nets' second fits,
        # back to back: a first fit pays for what the first runs set up
        fit("native", net, arg)
        fit("TorchModule", tnet, arg)
        fit("native again", net, arg)
        fit("TorchModule again", tnet, arg)
        for tag, start in ulps.items():
            fit(tag, net, start)
        torch_d = rows["TorchModule"]["diff"]
        torch_n = rows["TorchModule"]["norm"]
        ulp_d = [max(d) for d in zip(*(rows[t]["diff"] for t in ulps))]
        ulp_n = [max(d) for d in zip(*(rows[t]["norm"] for t in ulps))]
        on_card = all(t.device.type == CARD for t in
                      list(linear.parameters()) + list(linear.buffers()))
        ratio = rows["TorchModule again"]["step_ms"] / \
            rows["native again"]["step_ms"]
        log(f"[plugins] ResNet-50 b{REC_BATCH} fp32 with fc1 as "
            f"TorchModule(nn.Linear({n_in}, {n_out})) against the native "
            f"net, {PLUGIN_BATCHES} Module.fit batches from the same "
            f"weights (cuDNN deterministic), largest parameter difference "
            f"by step: " + " ".join(f"{d:.3e}" for d in torch_d)
            + f" (step 1 tolerance {PLUGIN_TOL}), relative L2 "
            + " ".join(f"{d:.3e}" for d in torch_n)
            + f" (step k's tolerance {PLUGIN_SPREAD} x k x the 1-ulp "
            f"spread's); the native net with fc1's weights 1 ulp up and "
            f"down, the larger: " + " ".join(f"{d:.3e}" for d in ulp_d)
            + ", relative L2 " + " ".join(f"{d:.3e}" for d in ulp_n)
            + f"; the native net again: {max(rows['native again']['diff'])}"
            f"; step ms, second fits: {rows['TorchModule again']['step_ms']:.3f}"
            f" against {rows['native again']['step_ms']:.3f} (ratio "
            f"{ratio:.4f}; first fits {rows['TorchModule']['step_ms']:.3f} "
            f"and {rows['native']['step_ms']:.3f}); "
            f"host syncs a batch {rows['TorchModule']['syncs_per_batch']:.1f}"
            f" (the Custom op's: 2); the torch layer on the card: "
            f"{on_card}; {smi}")
        if (torch_d[0] > PLUGIN_TOL or not on_card
                or max(rows["native again"]["diff"]) != 0
                or rows["TorchModule again"]["diff"] != torch_d
                or any(t > PLUGIN_SPREAD * k * u
                       for k, t, u in zip(range(2, len(torch_n) + 1),
                                          torch_n[1:], ulp_n[1:]))):
            raise AssertionError(f"TorchModule: differences {torch_d} "
                                 f"(relative L2 {torch_n}), 1 ulp {ulp_d} "
                                 f"({ulp_n}), on the card {on_card}")
        # TorchCriterion's gradient into fc1 against SoftmaxOutput's
        cid = tp.register_criterion(torch.nn.CrossEntropyLoss())
        cnet = sym.TorchCriterion(fc, sym.Variable("softmax_label"),
                                  criterion_id=cid, grad_scale=REC_BATCH)
        grads = {}
        x, y = batches[0]
        for tag, graph in (("SoftmaxOutput", net), ("TorchCriterion", cnet)):
            ex = graph.simple_bind(ctx=mx.gpu(0), data=tuple(x.shape),
                                   softmax_label=tuple(y.shape))
            ex.copy_params_from(arg, aux)
            ex.forward(is_train=True, data=x, softmax_label=y)
            ex.backward()
            grads[tag] = ex.grad_dict["fc1_weight"].clone()
        g, want = grads["TorchCriterion"], grads["SoftmaxOutput"]
        err = float((g - want).abs().max() / want.abs().max())
        log(f"[plugins] TorchCriterion(CrossEntropyLoss(), grad_scale="
            f"{REC_BATCH}) against SoftmaxOutput: fc1 gradient relative "
            f"difference {err:.3e} (tolerance {PLUGIN_TOL}), on "
            f"{g.device}; {smi}")
        if err > PLUGIN_TOL or g.device.type != CARD:
            raise AssertionError(f"TorchCriterion: fc1 gradient {err}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    rows["ratio"], rows["crit_err"] = ratio, err
    return rows


def _opencv_check(smi, local):
    """plugins.opencv_plugin.imdecode of OPENCV_RECORDS records against
    image.imdecode_np, bit for bit, through whichever route the machine
    has (cv2, else the port's own decode); the route is printed."""
    from mxnet_tpu_torch import image, recordio
    from mxnet_tpu_torch.plugins import opencv_plugin as cv

    rd = recordio.MXRecordIO(local, "r")
    payloads = [recordio.unpack(rd.read())[1] for _ in range(OPENCV_RECORDS)]
    rd.close()
    t0 = time.perf_counter()
    got = [cv.imdecode(p) for p in payloads]
    secs = time.perf_counter() - t0
    equal = all(np.array_equal(a.asnumpy(), image.imdecode_np(p).astype(
        np.float32)) for a, p in zip(got, payloads))
    route = "cv2" if cv._cv2 is not None else "the port's decode (no cv2)"
    log(f"[plugins] opencv_plugin.imdecode of {OPENCV_RECORDS} records "
        f"through {route}: {secs * 1e3 / OPENCV_RECORDS:.3f} ms an image, "
        f"on {got[0].context}, bit-equal to image.imdecode_np: {equal}; "
        f"{smi}")
    if not equal:
        raise AssertionError("opencv_plugin.imdecode differs from "
                             "image.imdecode_np")
    return {"route": route, "ms_per_image": secs * 1e3 / OPENCV_RECORDS}


def phase_remote_plugins(smi, recs):
    """Phase 43 (see the module docstring): remote I/O through a loopback
    S3 double and the plugins.  Returns its numbers."""
    with tempfile.TemporaryDirectory() as workdir, \
            S3Double(REMOTE_CREDENTIALS) as s3:
        out, mod = _with_env(s3.env(),
                             lambda: _remote_io(smi, recs, s3, workdir))
        bad = list(s3.bad)
    if bad:
        raise AssertionError(f"requests with a bad signature: {bad}")
    out["plugins"] = _plugin_fits(smi, mod, recs["train"])
    out["opencv"] = _opencv_check(smi, recs["train"])
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------- phase 44: lint, C, Perl
AMAL_FORWARDS = 5                # forwards through the amalgamated library
ENTRY_CALLS = 5                  # counted calls of an entry point run here
TICK_LAYERS = 2                  # the decoder's depth for the tick's count
TICK_TOKENS = 8                  # tokens each of the counted requests asks
PERL_CLIENT = r"""
use strict; use warnings;
use Time::HiRes qw(time);
use lib "%(blib)s/lib", "%(blib)s/arch";
use MXNetTPU;
my $t0 = time;
my $p = MXNetTPU::Predictor->new(
    symbol_file => "%(sym)s", params_file => "%(params)s",
    input_key => "data", input_shape => [%(shape)s],
    dev_type => 2, dev_id => 0);
my $t1 = time;
open my $in, '<:raw', "%(x)s" or die "cannot read the input: $!";
my $bytes = do { local $/; <$in> };
close $in;
my $out = $p->predict_packed($bytes);
my $t2 = time;
open my $fh, '>:raw', "%(out)s" or die "cannot write the output: $!";
print $fh $out;
close $fh;
printf "PERL OK create_s %%.3f forward_s %%.3f shape %%s\n",
    $t1 - $t0, $t2 - $t1, join(" ", @{$p->output_shape});
"""
# Each device-touching entry point of the lint's config (less the
# package prefix) with the earlier phase whose run shows its syncs: each
# of these phases raises on a host sync where none is sanctioned, so the
# script reaches phase 44 only if they held.
ENTRY_WITNESS = {
    "module.base_module.BaseModule._fit_epochs": (
        "phase_module_resnet", "Module.fit, 0 host syncs a batch "
        "(_resnet_fit)"),
    "trainer.FusedTrainer._fit_epochs": (
        "phase_train_resnet", "FusedTrainer.fit, 0 host syncs a batch "
        "(_resnet_fit)"),
    "trainer.FusedTrainer.step": (
        "phase_train_resnet", "fit's step(), 0 host syncs a batch "
        "(_resnet_fit)"),
    "trainer.FusedTrainer.step_multi": (
        "phase_train_records", "step_multi(8) over step_multi_feeds, 0 "
        "host syncs a call on the loop's thread (_ConsumerSyncs)"),
    "kvstore_fused.FusedUpdateEngine.handle_push": (
        "phase_module_amp", "the bucketed update's timed Module steps "
        "under set_sync_debug_mode('error')"),
    "kvstore_fused.FusedUpdateEngine.handle_pull": (
        "phase_module_amp", "the bucketed update's timed Module steps "
        "under set_sync_debug_mode('error')"),
    "kvstore.KVStoreDist.push": (
        "phase_dist_sync", "one wait a key a step on the loop's thread "
        "(KVStoreDist.wait_pulls, the sanctioned boundary: its "
        "loop_waits); the card's values leave on a side stream"),
    "kvstore.KVStoreDist.pull": (
        "phase_dist_sync", "one wait a key a step on the loop's thread "
        "(KVStoreDist.wait_pulls, the sanctioned boundary: its "
        "loop_waits)"),
    "kvstore_fused.FusedUpdateEngine._step_bucket": (
        "phase_collective", "(a) MXTPU_SHARD_UPDATE=0: one all-reduce a "
        "bucket, 0 host syncs a batch on the loop's thread (_SyncCounter)"),
    "kvstore_fused.FusedUpdateEngine._step_sharded": (
        "phase_collective", "(a) MXTPU_SHARD_UPDATE=1: reduce-scatter, "
        "the bucket's rule on the slice, all-gather, 0 host syncs a batch "
        "(_SyncCounter)"),
    "parallel.pipeline.make_pipeline_train_step.<locals>.step": (
        "phase_pipeline_moe", "(a) the 1F1B steps, host syncs a step "
        "counted (_SyncCounter)"),
    "parallel.pipeline._GPipe.forward": (
        "phase_pipeline_moe", "(b) a GPipe step with its backward, host "
        "syncs counted (_SyncCounter)"),
    "parallel.pipeline._GPipe.backward": (
        "phase_pipeline_moe", "(b) a GPipe step with its backward, host "
        "syncs counted (_SyncCounter)"),
    "parallel.moe.moe_ffn": (
        "phase_pipeline_moe", "(c) the MoE SGD steps, host syncs a step "
        "counted (_SyncCounter)"),
    "parallel.dist.exchange": (
        "phase_pipeline_moe", "every 1F1B tick's exchange, inside (a)'s "
        "counted steps"),
}
# entry points counted here (phase_port_lint): the tick at a reduced
# depth, the checkpoint's capture, and the host-only calls that need no
# server
ENTRY_RUN_HERE = (
    "serving.scheduler.SlotScheduler._tick",
    "serving.paged_kv.PagedSlots.step", "checkpoint.snapshot",
    "checkpoint.CheckpointManager.save", "telemetry.tracing.spans_payload",
    "telemetry.perf.publish_gauges", "telemetry.perf.profile_payload",
    "engine.push")
# host-only entry points that need a server or a cluster: HTTP, ring and
# dict work that touches no tensor (the lint proves no sync primitive is
# reachable); the phase that runs them
ENTRY_HOST_ONLY = {
    "parallel.coordinator.CoordinatorClient.step_poll": "phase_dist_sync",
    "parallel.coordinator.CoordinatorClient._heartbeat_loop":
        "phase_dist_sync",
    "telemetry.fleet.FleetScraper.scrape_once": "phase_dist_sync",
    "serving.router.ReplicaRouter.scrape_once": "phase_router",
    "serving.router.ReplicaRouter.route_generate": "phase_router",
}


def _port_lint_config():
    """The port lint's config module, loaded from its file alone (stdlib
    only: it imports nothing of the package)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "mxnet_tpu_torch", "analysis", "config.py")
    spec = importlib.util.spec_from_file_location("_port_lint_config", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _ThreadSyncs:
    """Within ``with``: ``torch.cuda.set_sync_debug_mode("warn")``, and
    each synchronizing-operation warning counted by the thread that
    raised it (``by_thread``), so a loop's own syncs part from those of
    the threads it feeds."""

    def __init__(self):
        import collections

        self.by_thread = collections.Counter()

    def count(self):
        """The syncs of the calling thread so far."""
        return self.by_thread[threading.get_ident()]

    def __enter__(self):
        import warnings

        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None,
                 line=None):
            if SYNC_WARNING in str(message):
                self.by_thread[threading.get_ident()] += 1
            else:
                shown(message, category, filename, lineno, file, line)
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self._cm.__exit__(*exc)
        return False


def _sync_probes():
    """``(static name, what, fn)``: each torch operation that may sync,
    named by the lint's primitive it falls under (None: not a primitive,
    a control the runtime must not flag either)."""
    from mxnet_tpu_torch import ndarray as tnd

    dev = torch.device("cuda", 0)
    t = torch.arange(-8, 8, dtype=torch.float32, device=dev)
    s = t.sum()
    reps = torch.full((16,), 2, dtype=torch.int64, device=dev)
    nd = tnd.array(np.arange(16, dtype=np.float32), ctx=dev)
    host = np.arange(4096, dtype=np.int32)

    def truth():
        if s:
            return 1
        return 0
    return [
        ("item", "t.sum().item()", lambda: s.item()),
        ("tolist", "t.tolist()", lambda: t.tolist()),
        ("cpu", "t.cpu()", lambda: t.cpu()),
        ("numpy", "t.numpy()", lambda: t.numpy()),
        ("asnumpy", "NDArray.asnumpy()", lambda: nd.asnumpy()),
        ("wait_to_read", "NDArray.wait_to_read()", lambda: nd.wait_to_read()),
        ("synchronize", "torch.cuda.synchronize()", torch.cuda.synchronize),
        ("synchronize", "Stream.synchronize()",
         lambda: torch.cuda.current_stream(dev).synchronize()),
        ("synchronize", "Event.synchronize()",
         lambda: _recorded_event(dev).synchronize()),
        ("nonzero", "t.nonzero()", lambda: t.nonzero()),
        ("masked_select", "t.masked_select(t > 0)",
         lambda: t.masked_select(t > 0)),
        ("unique", "t.unique()", lambda: t.unique()),
        ("equal", "torch.equal(t, t)", lambda: torch.equal(t, t)),
        ("repeat_interleave", "t.repeat_interleave(reps)",
         lambda: t.repeat_interleave(reps)),
        ("to-cpu", 't.to("cpu")', lambda: t.to("cpu")),
        ("float", "float(t.sum())", lambda: float(s)),
        ("int", "int(t.sum())", lambda: int(s)),
        ("bool", "bool(t.sum())", lambda: bool(s)),
        ("tensor-test", "if t.sum(): ...", truth),
        ("np.asarray", "np.asarray(t)", lambda: np.asarray(t)),
        ("h2d-upload", "torch.tensor(list, device=card)",
         lambda: torch.tensor(host.tolist(), device=dev)),
        ("h2d-upload", "torch.from_numpy(a).to(card)",
         lambda: torch.from_numpy(host).to(dev)),
        (None, "torch.from_numpy(a).pin_memory().to(card, "
               "non_blocking=True)",
         lambda: torch.from_numpy(host).pin_memory().to(
             dev, non_blocking=True)),
        (None, "t.repeat_interleave(reps, output_size=32)",
         lambda: t.repeat_interleave(reps, output_size=32)),
        (None, "t.repeat_interleave(2)", lambda: t.repeat_interleave(2)),
        (None, 't.to("cuda")', lambda: t.to("cuda")),
        (None, "t * 2 + 1", lambda: t * 2 + 1),
        (None, "torch.where(t > 0, t, 0)", lambda: torch.where(t > 0, t, 0)),
    ]


def _recorded_event(dev):
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


def _static_sync_names(cfg):
    """The primitive names the lint's config matches (host_sync.py)."""
    names = set(cfg.SYNC_METHODS) | set(cfg.SIZED_SYNC_METHODS)
    names |= {c.rsplit(".", 1)[-1] for c in cfg.SYNC_CALLS}
    names |= set(cfg.BUILTIN_CASTS) | {"tensor-test"}
    names |= {f"np.{f}" for f in cfg.NUMPY_SYNC_FUNCS}
    names |= {f"{m}-cpu" for m in cfg.HOST_COPY_METHODS}
    if cfg.UPLOAD_METHODS:
        names.add("h2d-upload")
    return names


def _sync_table(cfg):
    """Phase 44 (b): each probe under the sync debug mode; fails if the
    runtime flags an operation the static set lacks."""
    static = _static_sync_names(cfg)
    rows = []
    for name, what, fn in _sync_probes():
        torch.cuda.synchronize()
        raised = ""
        with _ThreadSyncs() as ts:
            try:
                fn()
            except (TypeError, RuntimeError) as exc:
                raised = type(exc).__name__
        flagged = ts.count() > 0
        rows.append({"op": what, "primitive": name, "flagged": flagged,
                     "raised": raised,
                     "static": name in static if name else False})
    missing = [r["op"] for r in rows if r["flagged"] and not r["static"]]
    table = "; ".join(
        f"{r['op']} -> {'flagged' if r['flagged'] else 'not flagged'}"
        f"{' (raises ' + r['raised'] + ')' if r['raised'] else ''}"
        f"{'' if r['primitive'] is None else ', static ' + r['primitive']}"
        for r in rows)
    return rows, missing, table


def _tick_syncs():
    """Ticks of a paged SlotScheduler over a TICK_LAYERS-deep decoder of
    the served configuration, after a warm-up request: the host syncs on
    the scheduler's thread in each counted tick (1: ``_host``, the
    sampled tokens), and the tick's ms."""
    from mxnet_tpu_torch.models import transformer as tr
    from mxnet_tpu_torch.models.decode import KVDecoder
    from mxnet_tpu_torch.serving.scheduler import SlotScheduler

    cfg = tr.MFU_HEADLINE_CONFIG
    shapes = tr.lm_param_shapes(TICK_LAYERS, cfg["num_heads"],
                                cfg["d_model"], cfg["d_ff"],
                                cfg["vocab_size"], MAX_LEN)
    dec = KVDecoder(tr.lm_random_params(shapes, seed=0, std=0.02),
                    num_layers=TICK_LAYERS, num_heads=cfg["num_heads"],
                    max_len=MAX_LEN, dtype=torch.bfloat16)
    sched = SlotScheduler(dec, num_slots=SLOTS, paged=True, kv_block=BLOCK,
                          queue_size=8)
    ticks, tick = [], SlotScheduler._tick
    counter = None

    def counted(self):
        if counter is None:
            return tick(self)
        n0, t0 = counter.count(), time.perf_counter()
        out = tick(self)
        ticks.append((counter.count() - n0, time.perf_counter() - t0))
        return out
    try:
        if sched.backend.kernel != "cuda":
            raise AssertionError(f"paged backend {sched.backend.kernel!r}")
        warm = sched.submit([1, 2, 3], max_new_tokens=2)
        warm.wait(300)
        SlotScheduler._tick = counted
        with _ThreadSyncs() as counter:
            reqs = [sched.submit(list(range(3 + i, 40 + i)),
                                 max_new_tokens=TICK_TOKENS, temperature=0)
                    for i in range(2)]
            for r in reqs:
                r.wait(300)
            counter = None
    finally:
        SlotScheduler._tick = tick
        sched.close()
    if any(r.outcome != "ok" for r in [warm, *reqs]):
        raise AssertionError(f"tick requests: {[r.outcome for r in reqs]}")
    counts = [n for n, _ in ticks]
    del dec
    return counts, [s * 1e3 for _, s in ticks]


def _caller_syncs(fn, calls=ENTRY_CALLS):
    """``fn`` once to warm up, then ``calls`` times counted: the host
    syncs on this thread (the threads it starts keep theirs)."""
    fn()
    torch.cuda.synchronize()
    with _ThreadSyncs() as ts:
        for _ in range(calls):
            fn()
    return ts.count()


def phase_port_lint(smi):
    """Phase 44 (a)-(c): ``python -m mxnet_tpu_torch.analysis --json`` as
    a child (exit 0; findings and suppressions by family); the sync
    primitives against the card; each host-sync entry point's witness.
    Returns (record, launches)."""
    from mxnet_tpu_torch import checkpoint as ck
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch.telemetry import perf, tracing

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.analysis",
                        "--json"], capture_output=True, text=True,
                       cwd=here, timeout=300)
    lint_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"port lint exited {r.returncode}:\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    doc = json.loads(r.stdout)
    fams = {}
    for f in doc["findings"]:
        row = fams.setdefault(f["rule"], {"findings": 0, "suppressed": 0})
        row["suppressed" if f["suppressed_by"] else "findings"] += 1
    log(f"[port-lint] python -m mxnet_tpu_torch.analysis --json: exit 0 in "
        f"{lint_s:.2f} s, {doc['violations']} findings, {doc['suppressed']}"
        f" suppressed; by family {json.dumps(fams, sort_keys=True)}; {smi}")

    cfg = _port_lint_config()
    rows, missing, table = _sync_table(cfg)
    log(f"[port-lint-syncs] under set_sync_debug_mode('warn'): {table}; "
        f"{smi}")
    if missing:
        raise AssertionError(f"the card flags {missing}, which the lint's "
                             f"static set lacks")

    _kernel_launches(reset=True)
    prefix = "mxnet_tpu_torch."
    entries = [e[len(prefix):] for e in cfg.ENTRY_POINTS]
    unclassified = [e for e in entries if e not in ENTRY_WITNESS and
                    e not in ENTRY_RUN_HERE and e not in ENTRY_HOST_ONLY]
    if unclassified:
        raise AssertionError(f"entry points with no witness: {unclassified}")
    here_counts = {}
    counts, tick_ms = _tick_syncs()
    if len(counts) < ENTRY_CALLS or any(n != 1 for n in counts):
        raise AssertionError(f"the tick's syncs: {counts} (want 1 a tick)")
    for name in ("serving.scheduler.SlotScheduler._tick",
                 "serving.paged_kv.PagedSlots.step"):
        here_counts[name] = (f"{len(counts)} ticks of a {TICK_LAYERS}-layer "
                             f"paged decoder, syncs a tick {counts} (the "
                             f"sanctioned _host), median tick "
                             f"{np.median(tick_ms):.3f} ms")
    tensors = {f"w{i}": torch.randn(1 << 20, device="cuda")
               for i in range(8)}
    snap = _caller_syncs(lambda: ck.snapshot(tensors))
    with tempfile.TemporaryDirectory() as wd:
        mgr = ck.CheckpointManager(wd, every=1, keep=2)
        step = iter(range(1, 100))

        def save():
            w = mgr.save(next(step), tensors)
            if w is not None:
                w.wait()        # the writer thread's syncs are its own
        saves = _caller_syncs(save)
    host = {
        "telemetry.tracing.spans_payload": tracing.spans_payload,
        "telemetry.perf.publish_gauges": perf.publish_gauges,
        "telemetry.perf.profile_payload": perf.profile_payload,
        "engine.push": lambda: engine.push(lambda: None)}
    host_counts = {k: _caller_syncs(fn) for k, fn in host.items()}
    engine.wait_for_all_host()
    if snap or saves or any(host_counts.values()):
        raise AssertionError(f"entry points synced: snapshot {snap}, save "
                             f"{saves}, host {host_counts}")
    here_counts["checkpoint.snapshot"] = (
        f"{ENTRY_CALLS} snapshots of 8 x 4 MiB on the card, 0 syncs")
    here_counts["checkpoint.CheckpointManager.save"] = (
        f"{ENTRY_CALLS} background saves, 0 syncs on the caller's thread "
        f"(the writer thread's are its own)")
    for k, n in host_counts.items():
        here_counts[k] = f"{ENTRY_CALLS} calls, {n} syncs"
    launches = _kernel_launches()
    lines = []
    for e in entries:
        if e in ENTRY_WITNESS:
            phase, what = ENTRY_WITNESS[e]
            lines.append(f"{e}: {phase} ({what})")
        elif e in here_counts:
            lines.append(f"{e}: here ({here_counts[e]})")
        else:
            lines.append(f"{e}: host only, run by {ENTRY_HOST_ONLY[e]}")
    log("[port-lint-entries] " + "; ".join(lines) + f"; {smi}")
    del tensors
    torch.cuda.empty_cache()
    return {"lint_s": lint_s, "families": fams, "sync_rows": rows,
            "tick_syncs": counts, "tick_ms": tick_ms}, launches


def phase_amalgamation(smi):
    """Phase 44 (d)-(e): the predict library built from ``python -m
    mxnet_tpu_torch.amalgamate --predict`` with one ``g++`` line, loaded
    here by ``ctypes``: ResNet-50 b32 fp32 224² on ``dev_type`` 2, a
    warm-up and AMAL_FORWARDS counted forwards, each epilogue launch held
    against the plain version, the outputs bit-equal to the Python
    ``Predictor``'s on the same params; then the Perl extension of
    ``mxnet_tpu_torch/bindings/perl`` built against the port's predict
    library and run once as a child on the same batch, bit-equal too
    (where ``perl`` or ``ExtUtils::MakeMaker`` is missing, one line says
    so and the phase goes on).  A phase of ``_side_by_side``: the Perl
    child runs beside phase 37's and 38's clients.  Returns (record,
    launches)."""
    from mxnet_tpu_torch import amalgamate, libinfo
    from mxnet_tpu_torch import ndarray as tnd
    from mxnet_tpu_torch.predict import Predictor

    here = os.path.dirname(os.path.abspath(__file__))
    n = PREDICT_BATCH
    net, arg, aux = _resnet50()
    x = np.random.default_rng(44).normal(size=(n, 3, 224, 224)).astype(
        np.float32)
    out = {}
    with tempfile.TemporaryDirectory() as wd:
        src, lib = os.path.join(wd, "mxtpu-all.cc"), \
            os.path.join(wd, "libmxtpu_predict_amal.so")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m",
                            "mxnet_tpu_torch.amalgamate", "--predict", "-o",
                            src], capture_output=True, text=True, cwd=here,
                           timeout=300)
        if r.returncode != 0:
            raise AssertionError(f"amalgamate: {r.stdout}\n{r.stderr}")
        gen_s = time.perf_counter() - t0
        cc_s = _client_build(amalgamate.build_command(src, lib, True),
                             "the amalgamated predict library")
        sym_path, params = os.path.join(wd, "net.json"), \
            os.path.join(wd, "net.params")
        with open(sym_path, "w") as f:
            f.write(net.tojson())
        tnd.save(params, {**{f"arg:{k}": tnd.array(v, ctx="cpu")
                             for k, v in arg.items()},
                          **{f"aux:{k}": tnd.array(v, ctx="cpu")
                             for k, v in aux.items()}})
        with open(params, "rb") as f:
            blob = f.read()
        x_path = os.path.join(wd, "x.f32")
        x.tofile(x_path)

        have = shutil.which("perl") and shutil.which("make") and \
            subprocess.run(["perl", "-MExtUtils::MakeMaker", "-e", "1"],
                           capture_output=True).returncode == 0
        perl_child = None
        if have:
            build = os.path.join(wd, "perl")
            shutil.copytree(os.path.join(here, "mxnet_tpu_torch", "bindings",
                                         "perl"), build)
            t0 = time.perf_counter()
            env = dict(os.environ, PYTHON=sys.executable)
            pred_lib = libinfo.find_lib_path("predict")
            for cmd in (["perl", "Makefile.PL", here, pred_lib], ["make"]):
                r = subprocess.run(cmd, cwd=build, env=env,
                                   capture_output=True, text=True,
                                   timeout=600)
                if r.returncode != 0:
                    raise AssertionError(f"{' '.join(cmd)} in the Perl "
                                         f"binding:\n{r.stdout[-3000:]}\n"
                                         f"{r.stderr[-3000:]}")
            perl_build_s = time.perf_counter() - t0
            script = os.path.join(wd, "client.pl")
            res = os.path.join(wd, "perl_out.f32")
            with open(script, "w") as f:
                f.write(PERL_CLIENT % {
                    "blib": os.path.join(build, "blib"), "sym": sym_path,
                    "params": params, "shape": f"{n}, 3, 224, 224",
                    "x": x_path, "out": res})
            perl_child = _Child(
                ["perl", script],
                libinfo.client_env({**os.environ, **TF32_OFF}),
                "the Perl client")
        yield [perl_child] if perl_child else []

        # the oracle: the Python Predictor on the same JSON and bytes
        p = Predictor(symbol_json_str=net.tojson(), param_bytes=blob,
                      input_shapes={"data": (n, 3, 224, 224)},
                      dev_type="cuda")
        p.forward(data=x)
        want = np.array(p.get_output(0))
        del p

        plib, check = _pred_lib(lib)
        keys = (ctypes.c_char_p * 1)(b"data")
        h = ctypes.c_void_p()
        t0 = time.perf_counter()
        check(plib.MXPredCreate(net.tojson().encode(), blob, len(blob), 2, 0,
                                1, keys, (ctypes.c_uint32 * 2)(0, 4),
                                (ctypes.c_uint32 * 4)(n, 3, 224, 224),
                                ctypes.byref(h)), "MXPredCreate")
        create_s = time.perf_counter() - t0
        got = np.empty((n, 1000), np.float32)
        xp = x.ctypes.data_as(ctypes.c_void_p)
        gp = got.ctypes.data_as(ctypes.c_void_p)

        def forward():
            check(plib.MXPredSetInput(h, b"data", xp, x.size),
                  "MXPredSetInput")
            check(plib.MXPredForward(h), "MXPredForward")
            check(plib.MXPredGetOutput(h, 0, gp, got.size),
                  "MXPredGetOutput")
            return got.copy()
        forward()                                       # warm-up
        torch.cuda.synchronize()
        _kernel_launches(reset=True)
        with _EpilogueRecorder() as recorder:
            t0 = time.perf_counter()
            outs = [forward() for _ in range(AMAL_FORWARDS)]
            fwd_ms = (time.perf_counter() - t0) / AMAL_FORWARDS * 1e3
        launches = _kernel_launches()
        checked = recorder.check("amalgamated predict library")
        plib.MXPredFree(h)
        unequal = [i for i, o in enumerate(outs)
                   if not np.array_equal(o, want)]
        log(f"[amalgamation] python -m mxnet_tpu_torch.amalgamate --predict "
            f"in {gen_s:.2f} s, one g++ line in {cc_s:.2f} s; the library "
            f"by ctypes in this process: MXPredCreate {create_s:.2f} s, "
            f"resnet50 b{n} fp32 dev_type 2, {AMAL_FORWARDS} forwards at "
            f"{fwd_ms:.3f} ms a call (SetInput + Forward + GetOutput), "
            f"{launches['residual_epilogue']} epilogue launches, "
            f"{checked} held against the plain version; outputs bit-equal "
            f"to the Python Predictor's in {AMAL_FORWARDS - len(unequal)} of "
            f"{AMAL_FORWARDS} forwards (max |diff| "
            f"{max(float(np.abs(o - want).max()) for o in outs):.3g}); {smi}")
        want_launches = 4 * AMAL_FORWARDS
        if launches["residual_epilogue"] != want_launches or \
                checked != want_launches or \
                any(v for k, v in launches.items()
                    if k != "residual_epilogue"):
            raise AssertionError(f"amalgamation: {launches}, {checked} "
                                 f"checked; want {want_launches} epilogue "
                                 f"launches and no other")
        if unequal:
            raise AssertionError(f"amalgamation: forwards {unequal} differ "
                                 f"from the Predictor's output")
        out.update({"generate_s": gen_s, "gxx_s": cc_s,
                    "create_s": create_s, "forward_ms": fwd_ms,
                    "epilogue_launches": launches["residual_epilogue"]})

        if perl_child is None:
            log("[amalgamation-perl] perl, make or ExtUtils::MakeMaker is "
                "missing on this machine: the Perl client is not built")
            out["perl"] = None
        else:
            stdout, run_s = perl_child.result()
            m = re.search(r"PERL OK create_s ([\d.]+) forward_s ([\d.]+) "
                          r"shape (.*)", stdout)
            if not m or m.group(3).strip() != f"{n} 1000":
                raise AssertionError(f"Perl client: {stdout[-2000:]}")
            perl_out = np.fromfile(res, np.float32).reshape(n, 1000)
            equal = bool(np.array_equal(perl_out, want))
            log(f"[amalgamation-perl] MXNetTPU::Predictor (dev_type 2) "
                f"built in {perl_build_s:.1f} s against "
                f"{os.path.basename(pred_lib)}, a "
                f"child perl ran {run_s:.1f} s (create "
                f"{float(m.group(1)):.2f} s, one forward "
                f"{float(m.group(2)):.3f} s): resnet50 b{n} outputs "
                f"{'bit-equal' if equal else 'NOT equal'} to the Python "
                f"Predictor's (max |diff| "
                f"{float(np.abs(perl_out - want).max()):.3g}); "
                f"NVIDIA_TF32_OVERRIDE=0; beside the other C clients; {smi}")
            if not equal:
                raise AssertionError("Perl client: outputs differ from the "
                                     "Predictor's")
            out["perl"] = {"build_s": perl_build_s, "run_s": run_s,
                           "create_s": float(m.group(1)),
                           "forward_s": float(m.group(2))}
    log(f"[amalgamation] {json.dumps(out)}")
    torch.cuda.empty_cache()
    return out, launches


# --------------------------------------------- phase 45: the device mesh
MESH_STEPS = 3                   # (a): eager steps of each trainer
MESH_MULTI_K = 3                 # (a): step_multi's steps
MESH_LAYERS = 2                  # (b): the LM's depth at its full widths
MESH_GLOO_BATCH = 4              # (b): the global batch (x 1024 tokens)
MESH_DECODE_BATCH = 4            # (b): prompts decoded together
MESH_DECODE_PROMPT = 16          # (b): prompt tokens
MESH_DECODE_TICKS = 32           # (b): greedy ticks after the prefill
MESH_ATTN = (2, 16, 1024, 128)   # (b): B, H, T, D of the Ulysses check
MESH_TIMEOUT_S = 300
# (a) world 1 over NCCL against the same trainer without a mesh, bf16:
# the one rank runs the same kernels on the same operands, except the
# vocab-parallel softmax (fp32 exp and sums by hand where torch.softmax
# has its own) and the all-reduces over one rank.  The outputs are held
# to 1e-2 of their norm each step and the Adam first moments after the
# steps to 5e-2 of each one's norm (phase 5's tolerances); the masters
# elementwise to two Adam bounds (an Adam step without bias correction
# moves an entry by at most (1 - b1^t) / sqrt(1 - b2^t) lr: 12.4 lr over
# 3 steps), since Adam turns a gradient of rounding noise into whole
# steps.  The key biases are left out of the moments: their gradient is
# 0 in exact arithmetic (softmax ignores a shift common to a row)
MESH_TOL = {"out": 1e-2, "moment": 5e-2, "param": 2 * 12.4e-4}
# (b) two ranks over gloo against one process, bf16 at 2 layers: the
# mean cross-entropy of each step to 5e-3 relative (the split products
# round their bf16 partial sums, a few bf16 ulps through 2 layers);
# Ulysses in fp32 against full_attention at the reference's 1e-4/1e-5;
# the bf16 decoder's logits along one token path to 5e-2 of their largest
# magnitude (8 layers of bf16 roundings, 2^-8 each), and every pick whose
# top-2 margin exceeds twice the logits' error equal
MESH_GLOO_TOL = {"loss": 5e-3, "attn": (1e-4, 1e-5), "bf16_logits": 5e-2}

MESH_WORKER = r"""
import faulthandler, json, os, sys, time, traceback
faulthandler.enable()
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import mxnet_tpu_torch  # noqa: F401
import torch.distributed as td
from mxnet_tpu_torch import convert, metric, telemetry
from mxnet_tpu_torch.models import transformer as tr
from mxnet_tpu_torch.ndarray import NDArray
from mxnet_tpu_torch.models.decode import KVDecoder
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel import ring_attention as ra
from mxnet_tpu_torch.trainer import FusedTrainer

MODE = os.environ["MESH_MODE"]
OUT = os.environ["MESH_OUT"]
RANK = int(os.environ["MXTPU_RANK"])
res = {"rank": RANK}
# started ahead of its turn: the card is touched once the go file exists
GO = os.environ.get("MESH_GO")
while GO and not os.path.exists(GO):
    time.sleep(0.05)


def dump():
    with open(os.path.join(OUT, "mesh_%s%d.json" % (MODE, RANK)), "w") as f:
        json.dump(res, f)


if MODE == "nccl":
    # two ranks on the one card over NCCL, as a launcher that gave each
    # rank a card of its own would set them up
    torch.cuda.set_device(0)
    td.init_process_group(
        "nccl", init_method="tcp://" + os.environ["MXTPU_COORDINATOR"],
        world_size=2, rank=RANK)
    try:
        x = torch.ones(4, device="cuda")
        td.all_reduce(x)
        torch.cuda.synchronize()
        res["error"] = None
    except Exception as exc:  # the refusal is what this mode records
        res["error"] = "%s: %s" % (type(exc).__name__, exc)
    dump()
    os._exit(0)

cfg = dict(tr.MFU_HEADLINE_CONFIG, num_layers=int(os.environ["MESH_LAYERS"]))
B, T, V = int(os.environ["MESH_BATCH"]), cfg["seq_len"], cfg["vocab_size"]
shapes = tr.lm_param_shapes(cfg["num_layers"], cfg["num_heads"],
                            cfg["d_model"], cfg["d_ff"], V, T)
weights = tr.lm_random_params(shapes, seed=0, std=0.02)
rng = np.random.default_rng(0)
data = rng.integers(0, V, (B, T)).astype(np.float32)
label = rng.integers(0, V, (B, T)).astype(np.float32)
STEPS = int(os.environ["MESH_STEPS"])
# phase 47 (c): the mesh trains again with a fused CrossEntropy over the
# global batch and the sentinel's flags and norm of each step
# (MXTPU_SENTINEL, which the launch sets: the one-process run and this
# second run read it, the mesh's first run has it off), parked unread
LABEL_ROWS = NDArray(torch.from_numpy(label.reshape(-1)))
METRIC = os.environ.get("MESH_METRIC") == "1"


def sentinel_rows():
    rows = [r["finite"].float().cpu().tolist()
            for r in telemetry.health._pending]
    telemetry.health._pending.clear()
    return rows


def local_nll(out, mesh):
    # the mean cross-entropy from this rank's block of the probabilities
    # (rows over 'data', classes over 'model'), summed over the world on
    # the host (gloo carries CPU tensors); each (row, class) block lies
    # on one rank of a (data, model) mesh
    p = out.to_local().float()
    rows, cols = p.shape
    r0 = mesh.coordinate("data") * rows
    c0 = mesh.coordinate("model") * cols
    lab = torch.from_numpy(label.reshape(-1)[r0:r0 + rows]).long() - c0
    idx = torch.nonzero((lab >= 0) & (lab < cols)).flatten()
    got = p[idx.to(p.device), lab[idx].to(p.device)]
    tot = torch.tensor([-torch.log(got.double() + 1e-30).sum().item()])
    td.all_reduce(tot)
    return float(tot.item()) / (B * T)


def trainer(mesh):
    t = FusedTrainer(tr.transformer_lm(**cfg), optimizer="adam",
                     optimizer_params={"lr": 1e-4}, dtype="bfloat16",
                     mesh=mesh,
                     sharding_rules=tmesh.megatron_rules() if mesh else ())
    t.init(data=(B, T), softmax_label=(B, T))
    convert.load_trainer_params(t, weights)
    return t


def run_train():
    # the no-mesh reference in rank 0, then the mesh; the results are
    # written after each part, so a rank that dies leaves what it did
    res["mesh_runs"] = {}
    if RANK == 0 and os.environ.get("MESH_PLAIN") == "1":
        plain = trainer(None)
        lab = torch.from_numpy(label.reshape(-1)).long().cuda()
        losses = []
        ce = metric.CrossEntropy()
        sentinel_rows()
        for _ in range(STEPS):
            o = plain.step(data=data, softmax_label=label)[0]
            if METRIC:
                ce.update([LABEL_ROWS], [NDArray(o)])
            o = o.float()
            losses.append(float(-torch.log(
                o[torch.arange(B * T, device="cuda"), lab].double()
                + 1e-30).mean()))
        res["plain_losses"] = losses
        if METRIC:
            res["plain_metric"] = ce.get()[1]
            res["plain_sentinel"] = sentinel_rows()
        del plain, o
        torch.cuda.empty_cache()
    dump()
    shape = tuple(json.loads(os.environ["MESH_SHAPE"]))
    mesh = tmesh.create_mesh(shape, ("data", "model"))
    res["backend"] = td.get_backend()
    sentinel = os.environ.pop("MXTPU_SENTINEL", None)
    # phase 45 (b): the mesh's default step; phase 47 (c): again with the
    # fused metric and the sentinel on
    runs = [("%dx%d" % shape, False)]
    if METRIC:
        runs.append(("%dx%d_sentinel" % shape, True))
    for name, measure in runs:
        res["running"] = name
        if measure:
            os.environ["MXTPU_SENTINEL"] = sentinel
        dump()
        t = trainer(mesh)
        fa.reset_launch_counts()
        ce = metric.CrossEntropy()
        sentinel_rows()
        t0 = time.perf_counter()
        losses = []
        for _ in range(STEPS):
            out = t.step(data=data, softmax_label=label)[0]
            if measure:
                ce.update([LABEL_ROWS], [NDArray(out)])
            losses.append(local_nll(out, mesh))
        torch.cuda.synchronize()
        run = res["mesh_runs"][name] = {
            "losses": losses, "s": time.perf_counter() - t0,
            "launches": fa.launch_counts()}
        if measure:
            # the window's one drain (its all-reduce over the world)
            telemetry.enable()
            drains = telemetry.get_registry().get("metric_host_sync_total")
            before = drains.value(metric=ce.name)
            run["metric"] = ce.get()[1]
            run["metric_drains"] = drains.value(metric=ce.name) - before
            run["metric_num_inst"] = ce.num_inst
            run["tokens"] = B * T * STEPS
            run["metric_placements"] = str(tuple(out.placements))
            run["sentinel"] = sentinel_rows()
        res["running"] = None
        dump()
        del t
        torch.cuda.empty_cache()


def run_serve():
    # KVDecoder at the served widths, 2-way 'model', against one process:
    # in fp32, greedy tokens over the prefill and the ticks; in bf16 the
    # logits along the dense decoder's greedy path (teacher-forced: bf16
    # logits tie, the dense decoder's own top-2 margin is 0 at some
    # picks, so a free-running greedy comparison is not defined there)
    dcfg = cfg
    dshapes = tr.lm_param_shapes(dcfg["num_layers"], dcfg["num_heads"],
                                 dcfg["d_model"], dcfg["d_ff"],
                                 dcfg["vocab_size"], dcfg["seq_len"])
    dweights = weights
    prompt = np.random.default_rng(1).integers(
        0, dcfg["vocab_size"], (int(os.environ["MESH_DB"]),
                                int(os.environ["MESH_DP"])))
    n_tok = int(os.environ["MESH_TICKS"]) + 1
    mesh = tmesh.create_mesh((2,), ("model",))
    res["backend"] = td.get_backend()

    def decoder(dtype, m):
        return KVDecoder(dweights, num_layers=dcfg["num_layers"],
                         num_heads=dcfg["num_heads"],
                         max_len=dcfg["seq_len"], dtype=dtype, mesh=m)

    def forced(dec, toks):
        st, lg = dec.prefill(prompt)
        out = [lg[:, -1].float()]
        for i in range(n_tok - 1):
            st, lg = dec.step(st, toks[:, i])
            out.append(lg.float())
        return torch.stack(out)                    # (ticks, B, V)

    tp = decoder("float32", mesh)
    t0 = time.perf_counter()
    res["tp_tokens"] = tp.generate(prompt, n_tok, temperature=0).tolist()
    res["tp_decode_s"] = time.perf_counter() - t0
    res["tp_cache"] = [str(tuple(tp.init_state(1)[0].placements))]
    del tp
    if RANK == 0:
        dense = decoder("float32", None)
        res["dense_tokens"] = dense.generate(prompt, n_tok,
                                             temperature=0).tolist()
        del dense
        dense = decoder("bfloat16", None)
        toks = dense.generate(prompt, n_tok, temperature=0)
        ref = forced(dense, toks)
        del dense
    else:
        toks = None
    box = [toks]
    td.broadcast_object_list(box, src=0)
    toks = box[0]
    got = forced(decoder("bfloat16", mesh), toks)
    if RANK == 0:
        top = torch.topk(ref, 2, dim=-1).values
        margin = top[..., 0] - top[..., 1]             # (ticks, B)
        err = (got - ref).abs().amax(-1)               # (ticks, B)
        clear = margin > 2 * err
        same = got.argmax(-1) == ref.argmax(-1)
        res["bf16_logit_err"] = float(err.max())
        res["bf16_logit_scale"] = float(ref.abs().max())
        res["bf16_picks"] = int(same.numel())
        res["bf16_clear_picks"] = int(clear.sum())
        res["bf16_clear_mismatch"] = int((clear & ~same).sum())
        res["bf16_ties"] = int((margin == 0).sum())
        res["dense_min_margin"] = float(margin.min())
    torch.cuda.empty_cache()

    # Ulysses over the two ranks in fp32 against full_attention
    b, h, t_, d = json.loads(os.environ["MESH_ATTN"])
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(b, h, t_, d, device="cuda", generator=g)
               for _ in range(3))
    mesh = tmesh.create_mesh((2,), ("seq",))
    ref = ra.full_attention(q, k, v, causal=True)
    out = ra.ulysses_attention(q, k, v, mesh, causal=True)
    blk = t_ // 2
    mine = ref[:, :, mesh.coordinate("seq") * blk:][:, :, :blk]
    res["ulysses_err"] = float((out.to_local() - mine).abs().max())
    dump()
    # the ring rotates K/V through dist.ppermute: gloo's all-to-all here
    # (gloo refuses P2P on CUDA tensors)
    out = ra.ring_attention(q, k, v, mesh, causal=True)
    res["ring_err"] = float((out.to_local() - mine).abs().max())


try:
    run_train()
    if os.environ.get("MESH_SERVE") == "1":
        run_serve()
    dump()
except Exception:
    res["traceback"] = traceback.format_exc()
    dump()
    sys.stdout.flush()
    os._exit(1)
sys.stdout.flush()
os._exit(0)
"""


def _free_ports(n):
    """``n`` distinct free loopback ports: each socket stays bound until
    all are picked (a port freed at once may be handed out again)."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _mesh_start(mode, out, extra_env, port, worker=MESH_WORKER):
    """Starts two ranks of ``worker`` sharing the card (``mode`` is
    ``MESH_MODE``) with their rendezvous on ``port``; returns the
    processes."""
    repo = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(out, f"{mode}_worker.py")
    if not os.path.exists(script):
        with open(script, "w") as f:
            f.write(worker)
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("MXTPU_", "DMLC_"))}
    base.update(PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p),
        MESH_MODE=mode, MESH_OUT=out, NVIDIA_TF32_OVERRIDE="0",
        MXTPU_COORDINATOR=f"127.0.0.1:{port}", MXTPU_NUM_WORKERS="2",
        **extra_env)
    procs = []
    for r in range(2):
        env = dict(base, MXTPU_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, script], env=env, cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True))
    return procs


def _mesh_kill(procs):
    import signal

    for q in procs:
        if q.poll() is None:
            os.killpg(q.pid, signal.SIGKILL)


def _mesh_children(mode, out, extra_env, crash_ok=False, procs=None):
    """Two ranks of ``MESH_WORKER`` sharing the card (``procs`` if
    ``_mesh_start`` started them already): ``[(result, output, exit
    code)]``.  A rank that fails fails the phase, unless ``crash_ok`` and
    it died of a signal (the caller reads what it wrote before); every
    child is killed on a timeout."""
    if procs is None:
        procs = _mesh_start(mode, out, extra_env, _free_ports(1)[0])
    texts = []
    deadline = time.perf_counter() + MESH_TIMEOUT_S
    for p in procs:
        try:
            text, _ = p.communicate(
                timeout=max(deadline - time.perf_counter(), 1))
        except subprocess.TimeoutExpired:
            _mesh_kill(procs)
            text, _ = p.communicate()
            raise AssertionError(f"mesh {mode}: no end in {MESH_TIMEOUT_S} "
                                 f"s:\n{text[-4000:]}")
        texts.append(text)
    crashed = crash_ok and any(p.returncode < 0 for p in procs)
    results = []
    for r, (p, text) in enumerate(zip(procs, texts)):
        path = os.path.join(out, f"mesh_{mode}{r}.json")
        res = {}
        if os.path.exists(path):
            with open(path) as f:
                res = json.load(f)
        if not crashed and (p.returncode != 0 or "traceback" in res
                            or not res):
            raise AssertionError(f"mesh {mode}: rank {r} exited "
                                 f"{p.returncode}:\n{res.get('traceback')}"
                                 f"\n{text[-6000:]}")
        results.append((res, text, p.returncode))
    return results


def _crash_site(text):
    """The collective a rank died in, from its faulthandler stack: the
    innermost ``torch.distributed`` call that is not a wait, and the
    DTensor step that made it."""
    m = re.search(r"Fatal Python error: (\w[^\n]*)", text)
    frames = re.findall(r'torch/distributed/([\w/]+)\.py", line \d+ in '
                        r'(\w+)', text[m.start():] if m else "")
    calls = [f"{mod.split('/')[-1]}.{fn}" for mod, fn in frames
             if fn not in ("wait_tensor", "wait", "__call__")]
    if not m or not calls:
        return None
    return f"{m.group(1).strip()} in {' <- '.join(calls[:2])}"


def _mesh_profile(run):
    """Device busy ms, idle share and the NCCL kernels of one ``run()``
    (a step), from torch.profiler; the idle share is against the
    profiled step's own wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, nccl, n_nccl = 0.0, 0.0, 0
    for ev in _profile_events(prof):
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = (ev.time_range.end - ev.time_range.start) / 1e3
        busy += ms
        if "nccl" in ev.name.lower():
            nccl += ms
            n_nccl += 1
    return {"busy_ms": busy, "profiled_wall_ms": wall_ms,
            "idle_share": 1 - busy / wall_ms, "nccl_kernels": n_nccl,
            "nccl_ms": nccl}


def _mesh_world1(smi):
    """(a): world 1 over NCCL at full width against the trainer without
    a mesh; returns the record and the kernels' launches on its main
    path (the mesh trainer's eager steps)."""
    import torch.distributed as td

    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.convert import load_trainer_params
    from mxnet_tpu_torch.models import transformer as tr
    from mxnet_tpu_torch.parallel import mesh as tmesh
    from mxnet_tpu_torch.trainer import FusedTrainer

    cfg = dict(tr.MFU_HEADLINE_CONFIG, num_layers=LATE_LM_LAYERS)
    B, T, V = TRAIN_BATCH, cfg["seq_len"], cfg["vocab_size"]
    mesh = tmesh.create_mesh((1, 1), ("data", "model"))
    backend = td.get_backend()
    if backend != "nccl":
        raise AssertionError(f"mesh (a): the world-1 group is {backend}")

    def trainer(m):
        return FusedTrainer(
            tr.transformer_lm(**cfg), optimizer="adam",
            optimizer_params={"lr": 1e-4}, dtype="bfloat16", mesh=m,
            sharding_rules=tmesh.megatron_rules() if m else ()).init(
            data=(B, T), softmax_label=(B, T))

    mxrandom.seed(0)
    plain = trainer(None)
    tm = trainer(mesh)
    load_trainer_params(tm, plain.params)
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.integers(0, V, (B, T)).astype(np.float32))
    label = torch.from_numpy(rng.integers(0, V, (B, T)).astype(np.float32))

    def timed(t, n):
        outs, ms = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(t.step(data=data, softmax_label=label)[0])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return outs, ms

    from mxnet_tpu_torch.ops import flash_attention as fa

    fa.reset_launch_counts()
    plain_outs, plain_ms = timed(plain, MESH_STEPS)
    plain_launches = fa.launch_counts()
    # the main path's run: every kernel count starts at 0 here; the
    # first step's flash launches are held against the plain version
    _kernel_launches(reset=True)
    rec = _FlashRecorder()
    with rec:
        mesh_outs, mesh_ms = timed(tm, 1)
    checked = rec.check("mesh (a) step 1")
    more, ms2 = timed(tm, MESH_STEPS - 1)
    mesh_outs += more
    mesh_ms += ms2
    launches = _kernel_launches()
    if {k: launches[k] for k in plain_launches} != plain_launches:
        raise AssertionError(f"mesh (a): launches {launches} against the "
                             f"plain trainer's {plain_launches}")
    if any(v != LATE_LM_LAYERS * MESH_STEPS
           for v in plain_launches.values()):
        raise AssertionError(f"mesh (a): {plain_launches} launches, want "
                             f"{LATE_LM_LAYERS} a step of each flash "
                             f"kernel")
    out_errs = [_rel_err(tmesh.full_value(a), b)
                for a, b in zip(mesh_outs, plain_outs)]
    p_err, p_name = max(
        (float((tmesh.full_value(tm.params[k]) - v).abs().max()), k)
        for k, v in plain.params.items())
    m_err, m_name = max(
        (_rel_err(tmesh.full_value(tm.opt_state[k][0]), st[0]), k)
        for k, st in plain.opt_state.items() if not k.endswith("_k_bias"))
    if max(out_errs) > MESH_TOL["out"] or p_err > MESH_TOL["param"] or \
            m_err > MESH_TOL["moment"]:
        raise AssertionError(f"mesh (a): outputs rel err {out_errs}, "
                             f"masters max |diff| {p_err} ({p_name}), "
                             f"first moments rel err {m_err} ({m_name}); "
                             f"tolerance {MESH_TOL}")
    if any(str(tm.params[k].placements) != want for k, want in (
            ("layer0_q_weight", "(Replicate(), Shard(dim=0))"),
            ("layer0_proj_weight", "(Replicate(), Shard(dim=1))"),
            ("lm_head_weight", "(Replicate(), Shard(dim=0))"))):
        raise AssertionError("mesh (a): the megatron placements")
    prof = _mesh_profile(lambda: tm.step(data=data, softmax_label=label))
    plain.step(data=data, softmax_label=label)    # the same step count
    # step_multi: a captured CUDA graph over NCCL, against the plain
    # trainer's captured steps from their (close) states
    stacked = {"data": torch.stack([data] * MESH_MULTI_K),
               "softmax_label": torch.stack([label] * MESH_MULTI_K)}
    pm = plain.step_multi(**stacked)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mm = tm.step_multi(**stacked)[0]
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    if len(tm._graphs) != 1:
        raise AssertionError("mesh (a): step_multi captured no graph")
    multi_err = max(_rel_err(tmesh.full_value(mm)[i], pm[i])
                    for i in range(MESH_MULTI_K))
    del pm, mm
    t0 = time.perf_counter()
    mm = tm.step_multi(**stacked)[0]
    torch.cuda.synchronize()
    multi_ms = (time.perf_counter() - t0) * 1e3 / MESH_MULTI_K
    if multi_err > MESH_TOL["out"]:
        raise AssertionError(f"mesh (a): step_multi outputs rel err "
                             f"{multi_err}")
    ratio = float(np.median(mesh_ms[1:]) / np.median(plain_ms[1:]))
    out = {"backend": backend, "steps": MESH_STEPS,
           "out_rel_err": out_errs, "param_max_abs": p_err,
           "param_worst": p_name, "moment_rel_err": m_err,
           "moment_worst": m_name, "step_ms": mesh_ms,
           "plain_step_ms": plain_ms, "ratio_to_plain": ratio,
           "flash_checked": checked, "flash_tiles": rec.tiles,
           "step_multi_rel_err": multi_err, "capture_s": capture_s,
           "step_multi_ms": multi_ms, **prof}
    log(f"[mesh] (a) world 1 over {backend}, MFU_HEADLINE_CONFIG bf16 Adam "
        f"batch {B} x {T}: mesh step {np.median(mesh_ms[1:]):.3f} ms vs "
        f"{np.median(plain_ms[1:]):.3f} ms without a mesh (ratio "
        f"{ratio:.4f}; a finding, not a claim); outputs rel err "
        f"{max(out_errs):.3g}, masters max |diff| {p_err:.3g} ({p_name}), "
        f"first moments {m_err:.3g} ({m_name}); flash "
        f"launches {launches} = the plain trainer's, first step's held "
        f"against the plain versions {checked} (worst tiles {rec.tiles}); "
        f"device busy {prof['busy_ms']:.3f} ms of a profiled step of "
        f"{prof['profiled_wall_ms']:.3f} ms, idle share "
        f"{prof['idle_share']:.4f}, {prof['nccl_kernels']} NCCL kernels "
        f"{prof['nccl_ms']:.3f} ms; step_multi captured in {capture_s:.2f} "
        f"s, {multi_ms:.3f} ms a step, rel err {multi_err:.3g}; {smi}")
    del plain, tm, mm
    gc.collect()
    torch.cuda.empty_cache()
    td.destroy_process_group()
    return out, launches


# (c): the fused CrossEntropy against its own run's per-step losses (the
# mean NLL from the same outputs, fp64 on the host): the window sums each
# rank's step in the prediction's dtype (bf16, as the reference's fused
# delta does), one rounding of at most 2^-9 relative, and each bf16 log
# another (unbiased, averaging out), so 2^-8 relative
COLL_METRIC_OWN_TOL = 2.0 ** -8


def _mesh_metric_sentinel(pair):
    """Phase 47 (c) from the (2, 1) pair of phase 45 (b), whose mesh
    trains a second time with the sentinel and the metric on: the fused
    CrossEntropy over the global batch of the 3 steps counts every token
    of the global batch on each rank, exactly, and is held to the run's
    own per-step losses (``COLL_METRIC_OWN_TOL``); the metric and the
    sentinel's flags and norm of each step, each rank's against rank 0's
    one-process run, are held to ``MESH_GLOO_TOL["loss"]`` relative (the
    bf16 products' rounding, as the losses); the metric read once a
    rank; the flash kernels' launches a rank."""
    r0 = pair[0][0]
    runs = [r["mesh_runs"]["2x1_sentinel"] for r, _, _ in pair]
    plain_m, plain_s = r0["plain_metric"], r0["plain_sentinel"]
    tol = MESH_GLOO_TOL["loss"]
    out = {"metric_plain": plain_m, "metric_mesh": runs[0]["metric"],
           "num_inst": [run["metric_num_inst"] for run in runs],
           "tokens": runs[0]["tokens"],
           "metric_own": [sum(run["losses"]) / len(run["losses"])
                          for run in runs],
           "norms_plain": [row[-1] for row in plain_s],
           "norms_mesh": [row[-1] for row in runs[0]["sentinel"]],
           "metric_drains": [run["metric_drains"] for run in runs],
           "placements": runs[0]["metric_placements"],
           "launches_by_rank": [run["launches"] for run in runs],
           "launches": {k: sum(run["launches"][k] for run in runs)
                        for k in runs[0]["launches"]}}
    out["metric_rel"] = max(abs(run["metric"] - plain_m) / plain_m
                            for run in runs)
    out["metric_own_rel"] = max(abs(run["metric"] - own) / own for run, own
                                in zip(runs, out["metric_own"]))
    rel = [abs(a[-1] - b[-1]) / b[-1] for run in runs
           for a, b in zip(run["sentinel"], plain_s)]
    out["norm_rel"] = max(rel) if rel else math.inf
    flags_equal = all(a[:-1] == b[:-1] and all(a[:-1]) for run in runs
                      for a, b in zip(run["sentinel"], plain_s))
    if (len(plain_s) != MESH_STEPS
            or any(len(run["sentinel"]) != MESH_STEPS for run in runs)
            or not flags_equal or out["norm_rel"] > tol
            or out["metric_rel"] > tol
            or out["metric_own_rel"] > COLL_METRIC_OWN_TOL
            or any(n != out["tokens"] for n in out["num_inst"])
            or any(d != 1 for d in out["metric_drains"])):
        raise AssertionError(f"collective (c): the metric and the sentinel "
                             f"over the (2, 1) mesh: {out}; the sentinel's "
                             f"rows {[run['sentinel'] for run in runs]} vs "
                             f"{plain_s}")
    return out


def phase_mesh(smi):
    """Phase 45: the device mesh.  (a) world 1 over NCCL at full width;
    (b) two ranks sharing the card over gloo; (c) NCCL's refusal of two
    ranks on one card.  Returns ``(record, launches of (a)'s main
    path)``."""
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory()
    dirs = {k: os.path.join(tmp.name, k) for k in ("2x1", "1x2", "nccl")}
    go = {k: os.path.join(tmp.name, "go_" + k) for k in ("2x1", "rest")}
    procs = {}
    try:
        env = {"MESH_LAYERS": str(MESH_LAYERS),
               "MESH_BATCH": str(MESH_GLOO_BATCH),
               "MESH_STEPS": str(MESH_STEPS),
               "MESH_DB": str(MESH_DECODE_BATCH),
               "MESH_DP": str(MESH_DECODE_PROMPT),
               "MESH_TICKS": str(MESH_DECODE_TICKS),
               "MESH_ATTN": json.dumps(MESH_ATTN)}
        # the three pairs of ranks start now and import beside (a); each
        # waits for its go file before it touches the card.  The first
        # pair trains (2, 1) against one process, then serves; the second
        # trains (1, 2); (c)'s pair, which only brings up NCCL and is
        # refused, runs beside the second, and both beside the first
        # (their times are not read)
        for d in dirs.values():
            os.makedirs(d)
        ports = _free_ports(3)
        # the (2, 1) pair is also phase 47 (c): its mesh trains a second
        # time with the fused metric and the sentinel on, against one
        # process
        procs["2x1"] = _mesh_start("gloo_train", dirs["2x1"], dict(
            env, MESH_SHAPE="[2, 1]", MESH_PLAIN="1", MESH_SERVE="1",
            MESH_METRIC="1", MXTPU_SENTINEL="warn", MESH_GO=go["2x1"]),
            ports[0])
        procs["1x2"] = _mesh_start("gloo_train", dirs["1x2"], dict(
            env, MESH_SHAPE="[1, 2]", MESH_GO=go["rest"]), ports[1])
        procs["nccl"] = _mesh_start("nccl", dirs["nccl"], {
            "NCCL_DEBUG": "WARN", "MESH_GO": go["rest"]}, ports[2])
        world1, launches = _mesh_world1(smi)
        t0 = time.perf_counter()
        # training, one pair of ranks a mesh: a rank that dies in a
        # collective gloo cannot carry on CUDA tensors is recorded by the
        # collective's name
        refused, worst, runs, tr_ = {}, {}, {}, []
        plain = None
        for gate in ("2x1", "rest"):
            open(go[gate], "w").close()
        t_nc = time.perf_counter()
        for name in ("2x1", "1x2"):
            pair = _mesh_children("gloo_train", dirs[name], None,
                                  crash_ok=True, procs=procs[name])
            tr_.append(pair)
            r0 = pair[0][0]
            plain = r0.get("plain_losses", plain)
            if plain is None or r0.get("backend") != "gloo" or \
                    "share" not in pair[0][1]:
                raise AssertionError(
                    f"mesh (b) {name}: backend {r0.get('backend')}, "
                    f"reference {plain}:\n{pair[0][1][-3000:]}")
            run = r0["mesh_runs"].get(name)
            if run is None:
                site = next((_crash_site(t) for _, t, rc in pair if rc < 0
                             and _crash_site(t)), None)
                if site is None:
                    raise AssertionError(
                        f"mesh (b) {name}: no result and no collective "
                        f"named:\n" + "\n".join(t[-3000:]
                                                 for _, t, _ in pair))
                refused[f"training {name}"] = site
                continue
            runs[name] = run
            err = max(abs(a - b) / b for a, b in zip(run["losses"], plain))
            worst[name] = err
            if err > MESH_GLOO_TOL["loss"]:
                raise AssertionError(f"mesh (b) {name}: losses "
                                     f"{run['losses']} vs {plain}")
            if any(v != MESH_LAYERS * MESH_STEPS
                   for v in run["launches"].values()):
                raise AssertionError(f"mesh (b) {name}: flash launches "
                                     f"{run['launches']}")
        gl = tr_[0]
        gloo_s = time.perf_counter() - t0
        coll = _mesh_metric_sentinel(gl)
        s0 = gl[0][0]
        if "ulysses_err" not in s0:
            raise AssertionError("mesh (b): the serving part did not run")
        if s0["tp_tokens"] != s0["dense_tokens"] or \
                gl[1][0]["tp_tokens"] != s0["dense_tokens"]:
            raise AssertionError(f"mesh (b): 2-way fp32 decode tokens "
                                 f"{s0['tp_tokens']} vs {s0['dense_tokens']}")
        if s0["bf16_logit_err"] > MESH_GLOO_TOL["bf16_logits"] * \
                s0["bf16_logit_scale"] or s0["bf16_clear_mismatch"]:
            raise AssertionError(f"mesh (b): bf16 2-way decode: logits err "
                                 f"{s0['bf16_logit_err']} (scale "
                                 f"{s0['bf16_logit_scale']}), "
                                 f"{s0['bf16_clear_mismatch']} of "
                                 f"{s0['bf16_clear_picks']} clear picks "
                                 f"differ")
        if s0["tp_cache"] != ["(Shard(dim=2),)"]:
            raise AssertionError(f"mesh (b): cache {s0['tp_cache']}")
        rtol, atol = MESH_GLOO_TOL["attn"]
        for r, _, _ in gl:
            if r["ulysses_err"] > atol + rtol * 10 or \
                    r["ring_err"] > atol + rtol * 10:
                raise AssertionError(f"mesh (b): Ulysses err "
                                     f"{r['ulysses_err']}, ring err "
                                     f"{r['ring_err']}")
        log(f"[mesh] (b) 2 ranks sharing the card over gloo, "
            f"{MESH_LAYERS}-layer LM at full widths (the decoder too), batch "
            f"{MESH_GLOO_BATCH} x 1024, bf16 Adam, {MESH_STEPS} steps: "
            f"losses without a mesh {plain}, "
            + "; ".join(f"{k} {v['losses']} (worst rel {worst[k]:.3g}, "
                        f"{v['s']:.2f} s, flash {v['launches']})"
                        for k, v in runs.items())
            + f"; KVDecoder 2-way model, {MESH_DECODE_BATCH} prompts x "
            f"{MESH_DECODE_PROMPT}: fp32 greedy tokens equal over the prefill "
            f"and {MESH_DECODE_TICKS} ticks ({s0['tp_decode_s']:.2f} s); "
            f"bf16 along the dense greedy path: logits max err "
            f"{s0['bf16_logit_err']:.4g} of scale "
            f"{s0['bf16_logit_scale']:.4g}, picks equal at all "
            f"{s0['bf16_clear_picks']} of {s0['bf16_picks']} whose dense "
            f"top-2 margin exceeds twice the error ({s0['bf16_ties']} exact "
            f"ties); Ulysses fp32 "
            f"{MESH_ATTN} max err {s0['ulysses_err']:.3g}, the ring "
            f"{max(r['ring_err'] for r, _, _ in gl):.3g} (its rotation by "
            f"dist.exchange's all_to_all_single); gloo refused on CUDA tensors: "
            f"{refused or 'nothing'}; {gloo_s:.1f} s; {smi}")
        nc = _mesh_children("nccl", dirs["nccl"], None, procs=procs["nccl"])
        errors = [r["error"] for r, _, _ in nc]
        dup = [line.strip() for _, text, _ in nc
               for line in text.splitlines() if "Duplicate GPU" in line]
        if not any(errors):
            raise AssertionError("mesh (c): NCCL took two ranks on one card")
        log(f"[mesh] (c) NCCL, two ranks on one card: "
            f"{errors[0]!r}; NCCL_DEBUG=WARN: {dup[:1]}; "
            f"{time.perf_counter() - t_nc:.1f} s, beside the 1x2 pair")
    finally:
        for pair in procs.values():
            _mesh_kill(pair)
        tmp.cleanup()
    record = {"world1": world1,
              "gloo": {"losses_plain": plain,
                       "runs": runs, "loss_rel_err": worst,
                       "decode_tokens_equal_fp32": True,
                       "bf16_logit_err": s0["bf16_logit_err"],
                       "bf16_clear_picks": s0["bf16_clear_picks"],
                       "bf16_ties": s0["bf16_ties"],
                       "ulysses_err": s0["ulysses_err"],
                       "ring_err": s0["ring_err"],
                       "refused": refused, "s": gloo_s,
                       "collective": coll},
              "nccl_refusal": {"error": errors[0], "warn": dup[:1]}}
    gl_launches = {k: sum(run["launches"].get(k, 0) for run in runs.values())
                   for k in launches}
    record["gloo_launches"] = gl_launches
    return record, launches


# -------------------------- phase 46: pipeline and expert parallelism
# The port's copies of the pipeline and MoE examples, their math as
# written there: examples/transformer-lm/common.py (lm_*),
# train_pp.py (pp_*), train_moe.py (moe_*),
# examples/model-parallel-lstm/lstm_pipeline.py (lstm_pp_*, run on the
# CPU only) and tools/pipeline_memory.py's GPipe route (pp_gpipe_loss;
# its table is phase 46 (b)).
# Weights come from a torch.Generator on the tensors' device; the CPU
# tests (tests/test_torch_pipeline.py, test_torch_moe.py) hand them the
# JAX side's numpy weights instead, through convert.from_jax_tree.
def lm_layer_norm(x, g, b, eps=1e-5):
    """common.py's two-pass LayerNorm."""
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * g + b


def lm_glorot(gen, *shape, scale=0.08):
    return torch.randn(shape, generator=gen, device=gen.device) * scale


def lm_zeros(gen, *shape):
    return torch.zeros(shape, device=gen.device)


def lm_ones(gen, *shape):
    return torch.ones(shape, device=gen.device)


def lm_causal_attention(q, k, v, n_heads):
    """Causal attention on [B, T, D] projections via the port's attention
    dispatcher (the flash kernels on the card where their gate takes the
    shape, their plain versions on the CPU)."""
    from mxnet_tpu_torch.parallel.ring_attention import attention

    B, T, D = q.shape
    dh = D // n_heads

    def sh(a):
        return a.reshape(B, T, n_heads, dh).transpose(1, 2)

    out = attention(sh(q), sh(k), sh(v), causal=True)
    return out.transpose(1, 2).reshape(B, T, D)


def lm_attention_block_params(gen, D, scale=0.08):
    """ln + q/k/v + out-projection parameter set for one block."""
    return {"ln1_g": lm_ones(gen, D), "ln1_b": lm_zeros(gen, D),
            "q_w": lm_glorot(gen, D, D, scale=scale),
            "k_w": lm_glorot(gen, D, D, scale=scale),
            "v_w": lm_glorot(gen, D, D, scale=scale),
            "proj_w": lm_glorot(gen, D, D, scale=scale),
            "proj_b": lm_zeros(gen, D)}


def pp_block(p, h, n_heads):
    """train_pp.py's pre-LN attention + 4x GELU FFN block on [mb, T, D]
    (a -1e9 causal mask, ``x @ W``)."""
    B, T, D = h.shape
    dh = D // n_heads
    x = lm_layer_norm(h, p["ln1_g"], p["ln1_b"])
    q, k, v = x @ p["q_w"], x @ p["k_w"], x @ p["v_w"]

    def sh(a):
        return a.reshape(B, T, n_heads, dh).transpose(1, 2)

    s = (sh(q) @ sh(k).transpose(-1, -2)) / math.sqrt(dh)
    mask = torch.ones((T, T), dtype=torch.bool, device=h.device).tril()
    s = torch.where(mask, s, -1e9)
    att = (torch.softmax(s, -1) @ sh(v)).transpose(1, 2)
    h = h + att.reshape(B, T, D) @ p["proj_w"] + p["proj_b"]
    x = lm_layer_norm(h, p["ln2_g"], p["ln2_b"])
    f = torch.nn.functional.gelu(x @ p["fi_w"] + p["fi_b"],
                                 approximate="tanh")
    return h + f @ p["fo_w"] + p["fo_b"]


def pp_block_params(gen, D):
    return {"ln1_g": lm_ones(gen, D), "ln1_b": lm_zeros(gen, D),
            "q_w": lm_glorot(gen, D, D), "k_w": lm_glorot(gen, D, D),
            "v_w": lm_glorot(gen, D, D),
            "proj_w": lm_glorot(gen, D, D), "proj_b": lm_zeros(gen, D),
            "ln2_g": lm_ones(gen, D), "ln2_b": lm_zeros(gen, D),
            "fi_w": lm_glorot(gen, D, 4 * D), "fi_b": lm_zeros(gen, 4 * D),
            "fo_w": lm_glorot(gen, 4 * D, D), "fo_b": lm_zeros(gen, D)}


def pp_make_stages(gen, n_stages, blocks_per_stage, D, vocab, n_heads):
    """train_pp.py's per-stage trees: embed on stage 0, final-norm + head
    on the last, ``blocks_per_stage`` blocks everywhere."""

    def trunk(bp, h):
        for i in range(next(iter(bp.values())).shape[0]):
            h = pp_block({k: v[i] for k, v in bp.items()}, h, n_heads)
        return h

    fns, trees = [], []
    for s in range(n_stages):
        one = [pp_block_params(gen, D) for _ in range(blocks_per_stage)]
        tree = {"blocks": {k: torch.stack([b[k] for b in one])
                           for k in one[0]}}
        if s == 0:
            tree["embed"] = lm_glorot(gen, vocab, D, scale=0.1)
            fns.append(lambda p, ids: trunk(p["blocks"],
                                            p["embed"][ids.long()]))
        elif s == n_stages - 1:
            tree["lnf_g"] = lm_ones(gen, D)
            tree["lnf_b"] = lm_zeros(gen, D)
            tree["head"] = lm_glorot(gen, D, vocab, scale=0.1)
            fns.append(lambda p, h: lm_layer_norm(
                trunk(p["blocks"], h), p["lnf_g"], p["lnf_b"]) @ p["head"])
        else:
            fns.append(lambda p, h: trunk(p["blocks"], h))
        trees.append(tree)
    return fns, trees


def pp_affine_data(gen, M, mb, T, vocab):
    """train_pp.py's affine toy language, y = 5x + 3 (mod vocab), as
    float-encoded ids ``[M, mb, T]``."""
    X = torch.randint(0, vocab, (M, mb, T), generator=gen, device=gen.device)
    return X.float(), ((X * 5 + 3) % vocab).float()


def pp_dense_loss(fns, trees, xs, ys):
    """The one-process oracle (tests/test_pipeline_moe.py's
    ``_dense_lm_loss``): the stage chain run sequentially, the mean of
    the microbatches' token NLL."""
    from mxnet_tpu_torch.ops.loss import token_nll

    tot = 0.0
    for m in range(xs.shape[0]):
        h = xs[m]
        for fn, tree in zip(fns, trees):
            h = fn(tree, h)
        tot = tot + token_nll(h, ys[m])
    return tot / xs.shape[0]


def moe_init_params(gen, n_layers, D, n_experts, vocab):
    """train_moe.py's parameters: attention blocks with an expert FFN of
    ``n_experts`` 4x-wide experts each."""
    blocks = []
    for _ in range(n_layers):
        b = lm_attention_block_params(gen, D)
        b.update({"ln2_g": lm_ones(gen, D), "ln2_b": lm_zeros(gen, D),
                  "gate_w": lm_glorot(gen, D, n_experts),
                  "w_in": lm_glorot(gen, n_experts, D, 4 * D),
                  "w_out": lm_glorot(gen, n_experts, 4 * D, D)})
        blocks.append(b)
    return {"embed": lm_glorot(gen, vocab, D),
            "head": lm_glorot(gen, D, vocab), "blocks": blocks}


def moe_gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


def moe_block_of(X, mesh, axis="expert"):
    """This rank's sequences of a batch every rank holds: the tokens the
    expert axis gives it, whole sequences (the batch must split)."""
    n = mesh.shape[axis]
    if X.shape[0] % n:
        raise ValueError(f"batch {X.shape[0]} does not split into whole "
                         f"sequences over the {n} ranks of {axis!r}")
    b = X.shape[0] // n
    return X[mesh.coordinate(axis) * b:][:b]


def moe_forward(params, X, n_heads, mesh, top_k, record=None):
    """train_moe.py's forward on this rank's sequences of ``X`` (every
    FFN a ``moe_ffn`` with tanh-GELU; attention and LayerNorm dense, on
    the rank's own sequences: the tokens the expert axis gives it).
    Returns (this rank's logits, the summed aux).  ``record`` collects
    each layer's MoE input (this rank's tokens)."""
    from mxnet_tpu_torch.parallel import mesh as tmesh
    from mxnet_tpu_torch.parallel.moe import moe_ffn

    X = moe_block_of(X, mesh)
    B, T = X.shape
    h = params["embed"][X.long()]
    D = h.shape[-1]
    n = mesh.shape["expert"]
    tok = tmesh.NamedSharding(mesh, ("expert", None))
    aux_total = 0.0
    for p in params["blocks"]:
        x = lm_layer_norm(h, p["ln1_g"], p["ln1_b"])
        att = lm_causal_attention(x @ p["q_w"].T, x @ p["k_w"].T,
                                  x @ p["v_w"].T, n_heads)
        h = h + att @ p["proj_w"].T + p["proj_b"]
        x = lm_layer_norm(h, p["ln2_g"], p["ln2_b"]).reshape(B * T, D)
        if record is not None:
            record.append(x.detach())
        xs = tmesh.from_block(x, mesh.device_mesh, tok.placements,
                              (n * B * T, D))
        y, aux = moe_ffn({"gate_w": p["gate_w"], "w_in": p["w_in"],
                          "w_out": p["w_out"]}, xs, mesh, "expert",
                         top_k=top_k, activation=moe_gelu)
        aux_total = aux_total + aux
        h = h + y.to_local().reshape(B, T, D)
    return h @ params["head"], aux_total


def moe_place(params, mesh):
    """The LM's parameters as this rank holds them: each expert weight a
    DTensor leaf of its own expert (``Shard(0)`` over ``expert``), the
    rest replicated leaves."""
    from mxnet_tpu_torch.parallel import mesh as tmesh

    sh = tmesh.NamedSharding(mesh, ("expert", None, None))

    def leaf(k, v):
        if k in ("w_in", "w_out"):
            return tmesh.from_block(tmesh.narrow_local(v, sh).clone(),
                                    mesh.device_mesh, sh.placements,
                                    v.shape).requires_grad_(True)
        return v.detach().clone().requires_grad_(True)

    return {"embed": leaf("embed", params["embed"]),
            "head": leaf("head", params["head"]),
            "blocks": [{k: leaf(k, v) for k, v in b.items()}
                       for b in params["blocks"]]}


def moe_leaves(params):
    """{name: leaf} of the LM's parameters: ``embed``, ``head`` and
    ``blocks.<i>.<name>``."""
    out = {"embed": params["embed"], "head": params["head"]}
    for i, b in enumerate(params["blocks"]):
        out.update({f"blocks.{i}.{k}": v for k, v in b.items()})
    return out


def moe_sgd_step(params, X, Y, n_heads, mesh, top_k, lr, aux_weight,
                 grads_out=None):
    """One step of train_moe.py's loop on this rank: the mean NLL over
    all tokens plus ``aux_weight`` times the aux, its gradient as the
    reference's ``jax.grad`` (each rank backpropagates its share and the
    replicated parameters' gradients are summed over the axis: one
    all-reduce of their flat concatenation), and SGD.  Returns (nll,
    aux) every rank holds; ``grads_out`` receives each leaf's gradient
    (an expert's: this rank's block) before the update."""
    import torch.distributed as td

    from mxnet_tpu_torch.ops.loss import token_nll
    from mxnet_tpu_torch.parallel.mesh import is_dtensor

    n = mesh.shape["expert"]
    logits, aux = moe_forward(params, X, n_heads, mesh, top_k)
    nll = token_nll(logits, moe_block_of(Y, mesh))
    ((nll + aux_weight * aux) / n).backward()
    named = moe_leaves(params)
    leaves = list(named.values())
    rep = [v for v in leaves if not is_dtensor(v)]
    if n > 1:
        flat = torch.cat([v.grad.reshape(-1) for v in rep]
                         + [nll.detach().reshape(1) / n])
        td.all_reduce(flat, group=mesh.get_group("expert"))
        off = 0
        for v in rep:
            v.grad.copy_(flat[off:off + v.numel()].view_as(v))
            off += v.numel()
        nll = flat[off]
    if grads_out is not None:
        grads_out.update({k: (v.grad.to_local() if is_dtensor(v) else
                              v.grad).clone() for k, v in named.items()})
    with torch.no_grad():
        for v in leaves:
            v.sub_(lr * v.grad)
            v.grad = None
    return nll.detach(), aux.detach()


def moe_dense_ffn(p, x, n_blocks, top_k, capacity_factor=1.25):
    """The one-process oracle of ``moe_ffn`` (tests/test_pipeline_moe.py's
    ``_dense_moe``/``_dense_moe_top2``, vectorized): the tokens ``x``
    [N, d] split into ``n_blocks`` equal blocks, each routed alone with
    the per-block capacity, every expert run on every token, the kept
    choices combined.  Returns (y, aux, routing): routing maps
    ``expert``/``slot``/``kept`` to [n_blocks, N/n_blocks, k] and
    ``probs`` to [n_blocks, N/n_blocks, E]."""
    gate_w, w_in, w_out = p["gate_w"], p["w_in"], p["w_out"]
    N, d = x.shape
    E = gate_w.shape[1]
    nt = N // n_blocks
    cap = max(1, int(capacity_factor * top_k * nt / E))
    xb = x.reshape(n_blocks, nt, d)
    probs = torch.softmax(xb @ gate_w, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
    expert = order[..., :top_k]
    top_p = probs.gather(-1, expert)
    gates = top_p if top_k == 1 else top_p / top_p.sum(-1, keepdim=True)
    counts = torch.zeros(n_blocks, 1, E, dtype=torch.long, device=x.device)
    slots = []
    for j in range(top_k):                  # choice-major slot claiming
        oh = torch.nn.functional.one_hot(expert[..., j], E)
        before = oh.cumsum(1) - oh + counts
        slots.append((before * oh).sum(-1))
        counts = counts + oh.sum(1, keepdim=True)
    slot = torch.stack(slots, -1)
    kept = slot < cap
    ys = torch.stack([moe_gelu(x @ w_in[e]) @ w_out[e] for e in range(E)])
    ys = ys.reshape(E, n_blocks, nt, d)
    y = torch.zeros_like(xb)
    for j in range(top_k):
        pick = ys.gather(0, expert[..., j][None, ..., None].expand(
            1, n_blocks, nt, d))[0]
        y = y + pick * (gates[..., j] * kept[..., j])[..., None]
    frac = torch.nn.functional.one_hot(expert[..., 0], E).float().mean(1)
    aux = (E * (frac * probs.mean(1)).sum(-1)).mean()
    return y.reshape(N, d), aux, {"expert": expert, "slot": slot,
                                  "kept": kept, "probs": probs}


def plain_causal_attention(q, k, v):
    """Causal attention on ``[B, H, T, dh]`` in the inputs' own dtype
    (fp64 stays fp64), the scores materialised: no kernel, the oracle's
    attention and the exact side of (c)'s flash check."""
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    t = s.shape[-1]
    mask = torch.ones(s.shape[-2], t, dtype=torch.bool,
                      device=s.device).tril()
    return torch.softmax(s.masked_fill(~mask, float("-inf")), -1) @ v


def moe_dense_forward(params, X, n_heads, n_blocks, top_k, routing=None,
                      qkv=None):
    """train_moe.py's forward in one process over the whole batch, in the
    parameters' dtype, its FFNs :func:`moe_dense_ffn` over ``n_blocks``
    blocks of tokens (the ranks' shares) and its attention
    :func:`plain_causal_attention`, independent of the flash kernels the
    port's forward runs.  ``qkv`` collects each layer's ``[B, H, T, dh]``
    q, k and v."""
    B, T = X.shape
    h = params["embed"][X.long()]
    D = h.shape[-1]
    dh = D // n_heads

    def heads(a):
        return a.reshape(B, T, n_heads, dh).transpose(1, 2)

    aux_total = 0.0
    for p in params["blocks"]:
        x = lm_layer_norm(h, p["ln1_g"], p["ln1_b"])
        q, k, v = (heads(x @ p[n].T) for n in ("q_w", "k_w", "v_w"))
        if qkv is not None:
            qkv.append((q.detach(), k.detach(), v.detach()))
        att = plain_causal_attention(q, k, v).transpose(1, 2).reshape(
            B, T, D)
        h = h + att @ p["proj_w"].T + p["proj_b"]
        x = lm_layer_norm(h, p["ln2_g"], p["ln2_b"]).reshape(B * T, D)
        y, aux, r = moe_dense_ffn(p, x, n_blocks, top_k)
        if routing is not None:
            routing.append(r)
        aux_total = aux_total + aux
        h = h + y.reshape(B, T, D)
    return h @ params["head"], aux_total


def moe_routing_check(port, oracle, tol):
    """Routing of one layer against the oracle's, per rank block: picks
    whose oracle probability is within ``tol`` of a neighbouring
    choice's are near ties, counted apart; experts must be equal at
    every other pick, and slots at every pick no near tie precedes in
    its block's choice-major order.  Returns (picks, near ties, expert
    mismatches, slot mismatches)."""
    srt = torch.sort(oracle["probs"], dim=-1, descending=True,
                     stable=True)[0]
    k = oracle["expert"].shape[-1]
    gap = srt[..., :-1] - srt[..., 1:] <= tol      # gap j: choices j, j+1
    pad = torch.zeros_like(gap[..., :1])
    tie = (torch.cat([gap, pad], -1) | torch.cat([pad, gap], -1))[..., :k]
    major = tie.transpose(1, 2).reshape(tie.shape[0], -1)   # choice-major
    clean = (major.long().cumsum(1) == 0).reshape(
        tie.shape[0], k, -1).transpose(1, 2)
    bad_e = ((port["expert"] != oracle["expert"]) & ~tie).sum()
    bad_s = ((port["slot"] != oracle["slot"]) & clean).sum()
    return int(tie.numel()), int(tie.sum()), int(bad_e), int(bad_s)


def lstm_pp_layer(params, xs):
    """lstm_pipeline.py's LSTM layer over a hidden-state sequence:
    [mb, T, H] -> [mb, T, H] (i2h + h2h -> i/f/o/g gates, a loop over
    T)."""
    mb, T, H = xs.shape
    c = xs.new_zeros(mb, H)
    h = xs.new_zeros(mb, H)
    hs = []
    for t in range(T):
        gates = xs[:, t] @ params["i2h_w"].T + params["i2h_b"] \
            + h @ params["h2h_w"].T + params["h2h_b"]
        i, f, o, g = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, 1)


def lstm_pp_layer_params(gen, H):
    return {"i2h_w": lm_glorot(gen, 4 * H, H, scale=0.1),
            "i2h_b": lm_zeros(gen, 4 * H),
            "h2h_w": lm_glorot(gen, 4 * H, H, scale=0.1),
            "h2h_b": lm_zeros(gen, 4 * H)}


def lstm_pp_build(gen, n_layers, H, vocab, mesh):
    """lstm_pipeline.py's parameters: one LSTM layer a stage, stacked and
    placed over ``pipe``; embedding and head outside the pipeline."""
    from mxnet_tpu_torch.parallel import pipeline as tpp

    trunk = tpp.shard_stacked(mesh, tpp.stack_stage_params(
        [lstm_pp_layer_params(gen, H) for _ in range(n_layers)]))
    return {"embed": lm_glorot(gen, vocab, H, scale=0.1),
            "head_w": lm_glorot(gen, H, vocab, scale=0.1),
            "head_b": lm_zeros(gen, vocab), "trunk": trunk}


def lstm_pp_make_losses(mesh, n_micro, X, Y, vocab):
    """lstm_pipeline.py's (pipe_loss, seq_loss): the LSTM stack through
    ``pipeline_apply`` and sequentially, the same NLL."""
    from mxnet_tpu_torch.parallel import mesh as tmesh
    from mxnet_tpu_torch.parallel import pipeline as tpp

    def stage_fn(p, x, stage):
        return lstm_pp_layer(p, x)

    def nll(logits, Y):
        lp = torch.log_softmax(logits, dim=-1)
        return -lp.gather(-1, Y.long()[..., None]).mean()

    def pipe_loss(params):
        h = params["embed"][X.long()]
        out = tpp.pipeline_apply(stage_fn, params["trunk"],
                                 tpp.microbatch(h, n_micro), mesh, "pipe")
        logits = out.reshape(tuple(X.shape) + (-1,)) @ params["head_w"] \
            + params["head_b"]
        return nll(logits, Y)

    def seq_loss(params):
        h = params["embed"][X.long()]
        trunk = {k: tmesh.full_value(v) for k, v in params["trunk"].items()}
        for i in range(next(iter(trunk.values())).shape[0]):
            h = lstm_pp_layer({k: v[i] for k, v in trunk.items()}, h)
        return nll(h @ params["head_w"] + params["head_b"], Y)

    return pipe_loss, seq_loss


def pp_gpipe_loss(fns, stacked, meta, xs, ys, mesh):
    """tools/pipeline_memory.py's GPipe route: autograd through
    ``pipeline_apply_tree``, the mean of the microbatches' NLL."""
    from mxnet_tpu_torch.ops.loss import token_nll
    from mxnet_tpu_torch.parallel import pipeline as tpp

    outs = tpp.pipeline_apply_tree(fns, stacked, meta, xs, mesh)
    tot = 0.0
    for m in range(xs.shape[0]):
        tot = tot + token_nll(outs[m], ys[m])
    return tot / xs.shape[0]


# the full-width runs of phase 46: the LM's widths (MFU_HEADLINE_CONFIG,
# models/transformer.py:106-107), two ranks sharing the card over gloo
PP_WIDTH = dict(D=2048, heads=16, T=1024, vocab=32768)
PP_LAYERS = 8                    # (a): 2 stages x 4 blocks
PP_MICRO, PP_MB = 4, 2           # (a): microbatches of 2 x 1024 tokens
PP_STEPS = 3                     # (a): 1 warm-up, 2 timed
PP_LR = 0.3                      # train_pp.py's SGD rate
PP_MEMORY_MICRO = (4, 8)         # (b): GPipe and 1F1B at 2 layers
MOE_LAYERS, MOE_BATCH, MOE_STEPS = 2, 4, 3    # (c): b4 x 1024, 3 steps
# train_moe.py's aux weight; its SGD rate 0.3 is set for d_model 32: at
# 2048 the example's init (glorot 0.08 at fan-ins to 8192, no final
# norm) starts the NLL at 426, and 0.3 diverges (602, then 22064, on an
# H100), which amplifies fp32 roundings 1e4-fold
MOE_LR, MOE_AUX = 1e-3, 0.01
MOE_BF16_TOKENS = 900            # (d): tokens a rank, all to expert 0
# (a) fp32 with TF32 off, the same stage functions on the same operands
# and shapes in both (the pipeline reorders no sum inside a stage): each
# step's loss to 1e-5 relative and each gradient leaf of a rank's stage
# to 1e-5 of its largest entry (2.4e-8 and 0 on an H100); the GPipe
# inference logits to 1e-5 of their largest magnitude.  (c) the MoE LM
# (fp32, the flash kernels) against a dense oracle in fp64 with plain
# attention, independent of every kernel: each step's NLL and aux to
# 1e-4 relative and the first step's gradients to 1e-3 of each leaf's
# largest entry, or MOE_SPREAD times as far as the same oracle in fp32
# lies from the fp64 one where that is farther (SGD at lr 1e-3 carries
# fp32's rounding on: on an H100 the fp32 oracle lies 5.1e-4 from the
# fp64 one by step 3, and 4.7e-4 in step 1's gradients).  Routing at
# step 1: the gate probabilities within MOE_TIE of the fp64 oracle's,
# and picks within MOE_TIE of a neighbouring choice near ties, counted
# apart.  MOE_TIE is ten times fp32's own reach there: the fp32 oracle's
# probabilities lie up to 1.04e-4 from fp64's at layer 1 on an H100.  The flash kernels on (c)'s own step-1 q, k, v against fp64
# attention: phase 2's fp32 limits (output 1e-5, gradients 1e-4 of the
# largest magnitude) or MOE_SPREAD times plain fp32 attention's error
# there.  (d) the reference test's: kept tokens within 0.02, dropped
# ones exactly 0.
PP_TOL = {"loss": 1e-5, "grad": 1e-5, "logits": 1e-5, "moe": 1e-4,
          "moe_grad": 1e-3, "bf16_kept": 0.02, "flash_fwd": 1e-5,
          "flash_bwd": 1e-4}
MOE_SPREAD, MOE_TIE = 4.0, 1e-3

PIPE_WORKER = r"""
import faulthandler, json, math, os, sys, time, traceback
faulthandler.enable()
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import mxnet_tpu_torch  # noqa: F401
import torch.distributed as td
import chip_smoke as cs
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops.loss import token_nll
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel import moe as tmoe
from mxnet_tpu_torch.parallel import pipeline as tpp
from mxnet_tpu_torch.parallel.ring_attention import attention

OUT = os.environ["MESH_OUT"]
RANK = int(os.environ["MXTPU_RANK"])
import torch.distributed.tensor  # noqa: F401,E402 - DTensor's import, ahead
import torch.utils.checkpoint  # noqa: F401,E402 - of the card's release

res = {"rank": RANK, "s": {}}
GO = os.environ.get("MESH_GO")
while GO and not os.path.exists(GO):
    time.sleep(0.05)
T0 = time.perf_counter()
W = cs.PP_WIDTH
D, H, T, V = W["D"], W["heads"], W["T"], W["vocab"]


def dump():
    with open(os.path.join(OUT, "mesh_pp%d.json" % RANK), "w") as f:
        json.dump(res, f)


def mark(tag):
    torch.cuda.synchronize()
    res["s"][tag] = time.perf_counter() - T0
    print("[rank %d] %s at %.2f s" % (RANK, tag, res["s"][tag]), flush=True)
    dump()


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def pp_train(mesh):
    # (a) train_pp's LM at 8 layers over 2 stages, 1F1B against the
    # sequential model in this process from the same weights
    stage = mesh.coordinate("pipe")
    gen = torch.Generator(device="cuda").manual_seed(0)
    fns, trees = cs.pp_make_stages(gen, 2, cs.PP_LAYERS // 2, D, V, H)
    xs, ys = cs.pp_affine_data(gen, cs.PP_MICRO, cs.PP_MB, T, V)
    stacked, meta = tpp.union_stack(trees, mesh)
    mark("a_built")
    # GPipe inference through pipeline_apply_tree against the chain
    with torch.no_grad():
        outs = tpp.pipeline_apply_tree(fns, stacked, meta, xs, mesh)
        err = scale = 0.0
        for m in range(xs.shape[0]):
            h = xs[m]
            for fn, tree in zip(fns, trees):
                h = fn(tree, h)
            err = max(err, float((outs[m] - h).abs().max()))
            scale = max(scale, float(h.abs().max()))
    res["apply_tree"] = {"max_err": err, "scale": scale}
    del outs, h
    mark("a_apply_tree")
    # the oracle: PP_STEPS SGD steps of the stage chain, a microbatch at
    # a time (its gradients summed as the pipeline sums them)
    M = xs.shape[0]
    paths = [tpp._tree_paths(tree)[1] for tree in trees]
    for leaves in paths:
        for v in leaves.values():
            v.requires_grad_(True)
    o_losses, o_grads = [], None
    for i in range(cs.PP_STEPS):
        tot = 0.0
        for m in range(M):
            loss = cs.pp_dense_loss(fns, trees, xs[m:m + 1], ys[m:m + 1]) / M
            loss.backward()
            tot += float(loss)
        o_losses.append(tot)
        if i == 0:
            o_grads = {k: v.grad.clone() for k, v in paths[stage].items()}
        with torch.no_grad():
            for leaves in paths:
                for v in leaves.values():
                    v.sub_(cs.PP_LR * v.grad)
                    v.grad = None
    del trees, paths
    torch.cuda.empty_cache()
    mark("a_oracle")
    step = tpp.make_pipeline_train_step(fns, token_nll, meta, mesh)
    losses, ms = [], []
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    syncs = []
    for i in range(cs.PP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the step's host syncs (a tensor read or a synchronising call)
        with cs._SyncCounter() as sc:
            loss, grads = step(stacked, xs, ys)
        syncs.append(sc.total())
        if i == 0:
            g_err = {}
            for k in meta.stage_keys[stage]:
                g = grads[k].to_local()[0]
                ref = o_grads[k]
                g_err[k] = float((g - ref).abs().max()
                                 / ref.abs().max().clamp_min(1e-30))
        with torch.no_grad():
            for k, w in stacked.items():
                w.to_local().sub_(cs.PP_LR * grads[k].to_local())
        losses.append(float(loss))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    res["pp"] = {
        "losses": losses, "oracle_losses": o_losses,
        "loss_rel_err": max(rel(a, b) for a, b in zip(losses, o_losses)),
        "grad_err": g_err, "worst_grad": max(g_err.values()),
        "step_ms": ms, "syncs": syncs,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "base_bytes": base, "stage": stage,
        "tick_bytes": cs.PP_MB * T * D * 4,
        "ticks": M + 2 * 2 - 1, "exchanges": M + 2 * 2 - 2,
        "bubble_1f1b": tpp.bubble_fraction_1f1b(2, M)}
    del stacked, grads, o_grads
    torch.cuda.empty_cache()
    mark("a_1f1b")


def pp_memory(mesh):
    # (b) tools/pipeline_memory.py's table at 2 layers: the peak memory
    # of a GPipe step (autograd through pipeline_apply_tree) and of a
    # 1F1B step, each over its own weights' baseline
    gen = torch.Generator(device="cuda").manual_seed(1)
    fns, trees = cs.pp_make_stages(gen, 2, 1, D, V, H)
    stacked, meta = tpp.union_stack(trees, mesh)
    del trees
    for v in stacked.values():
        v.requires_grad_(True)
    step = tpp.make_pipeline_train_step(fns, token_nll, meta, mesh)
    table = []
    for M in cs.PP_MEMORY_MICRO:
        xs, ys = cs.pp_affine_data(gen, M, cs.PP_MB, T, V)
        row = {"M": M, "bubble_gpipe": tpp.bubble_fraction(2, M),
               "bubble_1f1b": tpp.bubble_fraction_1f1b(2, M)}
        for route in ("gpipe", "1f1b"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if route == "gpipe":
                with cs._SyncCounter() as sc:
                    loss = cs.pp_gpipe_loss(fns, stacked, meta, xs, ys,
                                            mesh)
                    loss.backward()
                row["gpipe_syncs"] = sc.total()
                for v in stacked.values():
                    v.grad = None
            else:
                loss, grads = step(stacked, xs, ys)
                del grads
            torch.cuda.synchronize()
            row[route] = {"peak_bytes": torch.cuda.max_memory_allocated()
                          - base, "loss": float(loss),
                          "s": time.perf_counter() - t0}
            del loss
        table.append(row)
    res["memory"] = table
    del stacked
    torch.cuda.empty_cache()
    mark("b_memory")


def moe_run(mesh):
    # (c) train_moe's LM at 2 layers, expert mesh of 2, b4 x 1024, top-1
    # and top-2, MOE_STEPS SGD steps each, against the dense oracle in
    # this process: its first step's gradients (each rank its own blocks)
    # and, in rank 0, its losses
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = cs.moe_init_params(gen, cs.MOE_LAYERS, D, 2, V)
    X = torch.randint(0, V, (cs.MOE_BATCH, T), generator=gen, device="cuda")
    Y = (X * 5 + 3) % V
    me = mesh.coordinate("expert")
    out = {}
    for k in (1, 2):
        placed = cs.moe_place(params, mesh)
        rec = []
        with torch.no_grad():
            cs.moe_forward(placed, X, H, mesh, k, record=rec)
        n_tok = rec[0].shape[0]
        cap = max(1, int(1.25 * k * n_tok / 2))
        routing = []
        for p, x in zip(placed["blocks"], rec):
            probs = torch.softmax(x @ p["gate_w"], -1)
            e, pos, keep, _, _ = tmoe.route(probs, k, cap, x.dtype)
            routing.append({"expert": e.tolist(), "slot": pos.tolist(),
                            "probs": probs.tolist(),
                            "dropped": int((~keep).sum())})
        del rec
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nll, aux, grads, syncs = [], [], {}, []
        for i in range(cs.MOE_STEPS):
            with cs._SyncCounter() as sc:
                a, b = cs.moe_sgd_step(placed, X, Y, H, mesh, k, cs.MOE_LR,
                                       cs.MOE_AUX, grads if i == 0 else None)
            syncs.append(sc.total())
            nll.append(float(a))
            aux.append(float(b))
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        launches = fa.launch_counts()
        del placed
        # the all-to-all's time at this cap: [E, cap, d] fp32
        buf = torch.randn(2, cap, D, device="cuda")
        a2a = []
        for _ in range(4):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            td.all_to_all_single(torch.empty_like(buf), buf,
                                 group=mesh.get_group("expert"))
            torch.cuda.synchronize()
            a2a.append((time.perf_counter() - t1) * 1e3)
        del buf
        # the oracles from the same weights, plain attention (no kernel):
        # fp64, and fp32 for the rounding's own scale; all MOE_STEPS in
        # rank 0 (the losses), the first in rank 1 (its gradients)
        qkv = [] if RANK == 0 and k == 1 else None
        o64 = moe_oracle(params, X, Y, k, torch.float64, me, qkv)
        o32 = moe_oracle(params, X, Y, k, torch.float32, me)
        g_err, g_err32 = {}, {}
        for n, ref in o64["grads"].items():
            top = ref.abs().max().clamp_min(1e-30)
            g_err[n] = float((grads[n].double() - ref).abs().max() / top)
            g_err32[n] = float((o32["grads"][n].double() - ref).abs().max()
                               / top)
        out[k] = {"nll": nll, "aux": aux, "s": s, "launches": launches,
                  "syncs": syncs,
                  "routing": routing, "cap": cap,
                  "a2a_bytes": 2 * cap * D * 4, "a2a_ms": a2a[1:],
                  "grad_err": g_err, "grad_err32": g_err32,
                  "oracle_nll": o64["nll"], "oracle_aux": o64["aux"],
                  "oracle32_nll": o32["nll"], "oracle32_aux": o32["aux"],
                  "oracle32_prob_err": [
                      float((a["probs"].double() - b["probs"]).abs().max())
                      for a, b in zip(o32["routing"], o64["routing"])],
                  "oracle_routing": [
                      {n: r[n].tolist() for n in ("expert", "slot", "probs")}
                      for r in o64["routing"]]}
        del o64, o32, grads
        torch.cuda.empty_cache()
        if qkv:
            res["moe_flash"] = flash_vs_fp64(qkv)
            del qkv
            torch.cuda.empty_cache()
        mark("c_top%d" % k)
    res["moe"] = out


def moe_oracle(params, X, Y, k, dtype, me, qkv=None):
    # train_moe's steps in one process in dtype (the dense oracle, plain
    # attention): rank 0 runs MOE_STEPS (its NLL and aux by step), rank 1
    # the first.  Returns them, step 1's routing and step 1's gradients
    # (an expert's: this rank's block)
    p = {"embed": params["embed"].to(dtype, copy=True),
         "head": params["head"].to(dtype, copy=True),
         "blocks": [{n: v.to(dtype, copy=True) for n, v in b.items()}
                    for b in params["blocks"]]}
    leaves = cs.moe_leaves(p)
    for v in leaves.values():
        v.requires_grad_(True)
    nll, aux, routing, grads = [], [], [], {}
    for i in range(cs.MOE_STEPS if RANK == 0 else 1):
        logits, a = cs.moe_dense_forward(
            p, X, H, 2, k, routing=routing if i == 0 else None,
            qkv=qkv if i == 0 else None)
        l = token_nll(logits, Y)
        (l + cs.MOE_AUX * a).backward()
        nll.append(float(l))
        aux.append(float(a))
        del logits
        with torch.no_grad():
            if i == 0:
                grads = {n: (v.grad[me] if n.endswith(("w_in", "w_out"))
                             else v.grad).clone()
                         for n, v in leaves.items()}
            for v in leaves.values():
                v.sub_(cs.MOE_LR * v.grad)
                v.grad = None
    return {"nll": nll, "aux": aux, "routing": routing, "grads": grads}


def flash_vs_fp64(qkv):
    # the flash kernels (fp32, through the attention dispatcher) and plain
    # fp32 attention, each against plain fp64 attention, on (c)'s own
    # step-1 q, k and v of each layer (the fp64 oracle's) with a seeded
    # cotangent: the output and dQ, dK, dV, each as its largest error
    # over the fp64 value's largest magnitude; and the scores' std
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for q, k, v in qkv:
        dout = torch.randn(q.shape, generator=gen, device="cuda",
                           dtype=torch.float64)

        def run(fn, dtype):
            ins = [a.to(dtype, copy=True).requires_grad_(True)
                   for a in (q, k, v)]
            o = fn(*ins)
            o.backward(dout.to(dtype))
            res = [o.detach().double()] + [a.grad.double() for a in ins]
            del o, ins
            return res

        ref = run(cs.plain_causal_attention, torch.float64)
        row = {}
        for name, fn in (("flash", lambda a, b, c: attention(a, b, c,
                                                             causal=True)),
                         ("plain32", cs.plain_causal_attention)):
            got = run(fn, torch.float32)
            row[name] = [float((g - r).abs().max() / r.abs().max())
                         for g, r in zip(got, ref)]
            del got
        with torch.no_grad():
            sc = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
            t = sc.shape[-1]
            row["scores_std"] = float(sc.masked_select(torch.ones(
                t, t, dtype=torch.bool, device="cuda").tril()).std())
            del sc
        rows.append(row)
        del ref
    return rows


def bf16_routing(mesh):
    # (d) test_moe_bf16_routing_exact's case on the card: every token to
    # expert 0 with gate ~1, identity experts, bf16 activations
    d, n = 8, cs.MOE_BF16_TOKENS
    eye = torch.eye(d, device="cuda")
    params = {"gate_w": torch.cat([torch.full((d, 1), 50.0, device="cuda"),
                                   torch.zeros(d, 1, device="cuda")], 1),
              "w_in": torch.stack([eye] * 2), "w_out": torch.stack([eye] * 2)}
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.rand(2 * n, d, generator=gen, device="cuda") + 0.5
    y, _ = tmoe.moe_ffn(params, x.to(torch.bfloat16), mesh, "expert",
                        capacity_factor=1.25)
    mine = y.to_local().float()
    cap = int(1.25 * n / 2)
    xl = x[mesh.coordinate("expert") * n:][:n]
    res["bf16"] = {"cap": cap, "tokens": n,
                   "kept_err": float((mine[:cap] - xl[:cap]).abs().max()),
                   "dropped_nonzero": int((mine[cap:] != 0).sum())}
    mark("d_bf16")


try:
    mesh = tmesh.create_mesh((2,), ("pipe",))
    res["backend"] = td.get_backend()
    mark("mesh")
    pp_train(mesh)
    pp_memory(mesh)
    emesh = tmesh.create_mesh((2,), ("expert",))
    moe_run(emesh)
    bf16_routing(emesh)
    dump()
except Exception:
    res["traceback"] = traceback.format_exc()
    dump()
    sys.stdout.flush()
    os._exit(1)
sys.stdout.flush()
os._exit(0)
"""


def _pp_check_moe(r0, r1):
    """(c)'s checks: each rank's NLL and aux against rank 0's fp64
    oracle, its first step's gradients against its own, each rank
    block's routing at step 1 against the fp64 oracle's, and the flash
    kernels on step 1's q, k, v against fp64 attention.  Returns the
    record by top-k, the flash check's rows and the checks that failed
    (the caller logs the readings before it raises)."""
    def rel(a, b):
        return abs(a - b) / abs(b)

    out, failed = {}, []
    for k in ("1", "2"):
        got, want = r0["moe"][k], r0["moe"][k]
        errs, tols = [], []
        for n in ("nll", "aux"):
            o64, o32 = want["oracle_" + n], want["oracle32_" + n]
            for r in (r0, r1):
                for a, b, c in zip(r["moe"][k][n], o64, o32):
                    errs.append(rel(a, b))
                    tols.append(max(PP_TOL["moe"], MOE_SPREAD * rel(c, b)))
        g_err, g_tol = {}, {}
        for n in got["grad_err"]:
            g_err[n] = max(r["moe"][k]["grad_err"][n] for r in (r0, r1))
            g_tol[n] = max(PP_TOL["moe_grad"], MOE_SPREAD * max(
                r["moe"][k]["grad_err32"][n] for r in (r0, r1)))
        if any(e > t for e, t in zip(errs, tols)) or any(
                g_err[n] > g_tol[n] for n in g_err):
            failed.append(
                f"phase 46 (c) top-{k}: NLL/aux {got['nll']}/{got['aux']} "
                f"vs the fp64 oracle {want['oracle_nll']}/"
                f"{want['oracle_aux']} (fp32 oracle {want['oracle32_nll']}/"
                f"{want['oracle32_aux']}), grads {g_err} against {g_tol}")
        checks = []
        for layer, orc in enumerate(want["oracle_routing"]):
            port = {n: torch.tensor([r["moe"][k]["routing"][layer][n]
                                     for r in (r0, r1)])
                    for n in ("expert", "slot", "probs")}
            o = {n: torch.tensor(orc[n]) for n in ("expert", "slot",
                                                   "probs")}
            p_err = float((port["probs"] - o["probs"]).abs().max())
            if p_err > MOE_TIE:
                failed.append(f"phase 46 (c) top-{k} layer {layer}: gate "
                              f"probabilities {p_err} from the fp64 "
                              f"oracle's (limit {MOE_TIE})")
            picks, ties, bad_e, bad_s = moe_routing_check(port, o, MOE_TIE)
            if bad_e or bad_s:
                failed.append(f"phase 46 (c) top-{k} layer {layer}: "
                              f"{bad_e} experts, {bad_s} slots differ of "
                              f"{picks} picks")
            checks.append({"picks": picks, "near_ties": ties,
                           "prob_err": p_err,
                           "prob_err32": want["oracle32_prob_err"][layer],
                           "dropped": [r["moe"][k]["routing"][layer]
                                       ["dropped"] for r in (r0, r1)]})
        launches = [r["moe"][k]["launches"] for r in (r0, r1)]
        want_n = MOE_LAYERS * MOE_STEPS
        if any(v != want_n for lc in launches for v in lc.values()):
            failed.append(f"phase 46 (c) top-{k}: flash launches "
                          f"{launches}, want {want_n} of each a rank")
        worst = max(range(len(errs)), key=lambda i: errs[i] / tols[i])
        out[k] = {"nll": got["nll"], "oracle_nll": want["oracle_nll"],
                  "oracle32_nll": want["oracle32_nll"],
                  "aux": got["aux"], "oracle_aux": want["oracle_aux"],
                  "worst_rel_err": errs[worst],
                  "worst_rel_tol": tols[worst],
                  "oracle32_rel": max(rel(c, b) for n in ("nll", "aux")
                                      for b, c in zip(want["oracle_" + n],
                                                      want["oracle32_" + n])),
                  "worst_grad": max(g_err.values()),
                  "worst_grad_leaf": max(g_err, key=g_err.get),
                  "worst_grad32": max(max(r["moe"][k]["grad_err32"].values())
                                      for r in (r0, r1)),
                  "grad_tol": max(g_tol.values()),
                  "routing": checks, "launches": launches,
                  "s": [r["moe"][k]["s"] for r in (r0, r1)],
                  "cap": got["cap"], "a2a_bytes": got["a2a_bytes"],
                  "a2a_ms": [r["moe"][k]["a2a_ms"] for r in (r0, r1)]}
    names = ("output", "dQ", "dK", "dV")
    for layer, row in enumerate(r0["moe_flash"]):
        for i, name in enumerate(names):
            lim = max(PP_TOL["flash_fwd" if i == 0 else "flash_bwd"],
                      MOE_SPREAD * row["plain32"][i])
            if row["flash"][i] > lim:
                failed.append(
                    f"phase 46 (c) layer {layer}: flash {name} "
                    f"{row['flash'][i]:.3g} from fp64 attention, limit "
                    f"{lim:.3g} (plain fp32 {row['plain32'][i]:.3g})")
    return out, r0["moe_flash"], failed


def phase_pipeline_moe(smi, procs, out_dir):
    """Phase 46: pipeline and expert parallelism at the LM's full width,
    two ranks sharing the card over gloo (``PIPE_WORKER``, started by
    :func:`_pp_start` beside earlier phases and released here).  Returns
    ``(record, the flash kernels' launches in the ranks' (c) runs)``."""
    t0 = time.perf_counter()
    open(os.path.join(out_dir, "go_pp"), "w").close()
    pair = _mesh_children("pp", out_dir, None, procs=procs)
    r0, r1 = (r for r, _, _ in pair)
    wall = time.perf_counter() - t0
    if r0.get("backend") != "gloo":
        raise AssertionError(f"phase 46: backend {r0.get('backend')}")
    pp = [r["pp"] for r in (r0, r1)]
    worst_g = max(p["worst_grad"] for p in pp)
    worst_l = max(p["loss_rel_err"] for p in pp)
    if worst_l > PP_TOL["loss"] or worst_g > PP_TOL["grad"]:
        raise AssertionError(f"phase 46 (a): losses {pp[0]['losses']} vs "
                             f"{pp[0]['oracle_losses']}, grads worst "
                             f"{[p['grad_err'] for p in pp]}")
    at = [r["apply_tree"] for r in (r0, r1)]
    if max(a["max_err"] / a["scale"] for a in at) > PP_TOL["logits"]:
        raise AssertionError(f"phase 46 (a): apply_tree logits {at}")
    mem = r0["memory"], r1["memory"]
    for rows in mem:
        for row in rows:
            if abs(row["gpipe"]["loss"] - row["1f1b"]["loss"]) > \
                    PP_TOL["loss"] * abs(row["1f1b"]["loss"]):
                raise AssertionError(f"phase 46 (b): GPipe and 1F1B losses "
                                     f"{row}")
    moe, moe_flash, moe_failed = _pp_check_moe(r0, r1)
    bf = [r["bf16"] for r in (r0, r1)]
    if any(b["kept_err"] > PP_TOL["bf16_kept"] or b["dropped_nonzero"]
           for b in bf):
        raise AssertionError(f"phase 46 (d): {bf}")
    tok = PP_MICRO * PP_MB * PP_WIDTH["T"]
    step_ms = [float(np.median(p["step_ms"][1:])) for p in pp]
    gib = 2 ** 30
    log(f"[pipeline] (a) train_pp's LM at {PP_LAYERS} layers, d_model "
        f"{PP_WIDTH['D']}, vocab {PP_WIDTH['vocab']}, 2 stages x "
        f"{PP_LAYERS // 2} blocks on 2 ranks sharing the card over gloo, "
        f"1F1B M {PP_MICRO} x {PP_MB} x {PP_WIDTH['T']} fp32 SGD: losses "
        f"{pp[0]['losses']} vs the one-process oracle "
        f"{pp[0]['oracle_losses']} (worst rel {worst_l:.3g}, tol "
        f"{PP_TOL['loss']}); step-1 grads of each rank's stage, worst "
        f"|diff| / max {pp[0]['worst_grad']:.3g} (stage 0), "
        f"{pp[1]['worst_grad']:.3g} (stage 1), tol {PP_TOL['grad']}; "
        f"steps {pp[0]['step_ms']} ms (rank 0), {max(step_ms):.1f} ms "
        f"timed, {tok / max(step_ms) * 1e3:.0f} tokens/s; exchange "
        f"dist.exchange's all_to_all_single ({pp[0]['exchanges']} a step, "
        f"{pp[0]['tick_bytes']} bytes a tick each way); peak memory "
        f"{pp[0]['peak_bytes'] / gib:.2f} / {pp[1]['peak_bytes'] / gib:.2f} "
        f"GiB (weights {pp[0]['base_bytes'] / gib:.2f} / "
        f"{pp[1]['base_bytes'] / gib:.2f}); pipeline_apply_tree logits "
        f"max err {at[0]['max_err']:.3g} of {at[0]['scale']:.3g}; two "
        f"ranks on one card measure no multi-card speed; {smi}")
    log("[pipeline] (b) peak memory over the weights, 2 layers, GiB "
        "(rank 0 / rank 1): " + "; ".join(
            f"M {a['M']}: GPipe {a['gpipe']['peak_bytes'] / gib:.2f} / "
            f"{b['gpipe']['peak_bytes'] / gib:.2f}, 1F1B "
            f"{a['1f1b']['peak_bytes'] / gib:.2f} / "
            f"{b['1f1b']['peak_bytes'] / gib:.2f} (bubbles "
            f"{a['bubble_gpipe']:.3f}, {a['bubble_1f1b']:.3f}; losses equal "
            f"to {abs(a['gpipe']['loss'] - a['1f1b']['loss']):.2g})"
            for a, b in zip(*mem)) + f"; {smi}")
    for k, m in moe.items():
        log(f"[moe] (c) train_moe's LM at {MOE_LAYERS} layers, d_model "
            f"{PP_WIDTH['D']}, vocab {PP_WIDTH['vocab']}, expert mesh of 2 "
            f"over gloo, b{MOE_BATCH} x {PP_WIDTH['T']}, "
            f"top-{k}, {MOE_STEPS} SGD steps: NLL {m['nll']} vs the dense "
            f"fp64 oracle's {m['oracle_nll']} (plain attention; in fp32 "
            f"{m['oracle32_nll']}), aux {m['aux']} vs {m['oracle_aux']} "
            f"(nearest its limit: rel {m['worst_rel_err']:.3g} of "
            f"{m['worst_rel_tol']:.3g}; the fp32 oracle's worst rel "
            f"{m['oracle32_rel']:.3g}); step-1 "
            f"grads worst |diff| / max {m['worst_grad']:.3g} "
            f"({m['worst_grad_leaf']}; the fp32 oracle's "
            f"{m['worst_grad32']:.3g}; tol {m['grad_tol']:.3g}); routing at "
            f"step 1 equal at every clear pick: "
            + ", ".join(f"layer {i} {c['picks']} picks, {c['near_ties']} "
                        f"near ties (gate probabilities within "
                        f"{c['prob_err']:.3g} of fp64, the fp32 oracle's "
                        f"{c['prob_err32']:.3g}, limit {MOE_TIE}), "
                        f"dropped {c['dropped']}"
                        for i, c in enumerate(m["routing"]))
            + f"; capacity {m['cap']}, all-to-all {m['a2a_bytes']} bytes, "
            f"{m['a2a_ms']} ms; flash launches in each rank "
            f"{m['launches']}; {m['s']} s; {smi}")
    log(f"[pipeline] host syncs a step on each rank's loop thread "
        f"(rank 0 / rank 1; tensor reads and synchronising calls under "
        f"set_sync_debug_mode('warn')): 1F1B {r0['pp']['syncs']} / "
        f"{r1['pp']['syncs']}; a GPipe step with its backward "
        + ", ".join(f"M {a['M']} {a['gpipe_syncs']} / {b['gpipe_syncs']}"
                    for a, b in zip(r0["memory"], r1["memory"]))
        + "; a MoE SGD step "
        + ", ".join(f"top-{k} {r0['moe'][k]['syncs']} / "
                    f"{r1['moe'][k]['syncs']}" for k in r0["moe"]))
    log(f"[moe] (c) the flash kernels (fp32) on step 1's q, k, v of each "
        f"layer against fp64 attention, largest error over the largest "
        f"magnitude of output, dQ, dK, dV: "
        + "; ".join(f"layer {i} (scores std {r['scores_std']:.1f}) flash "
                    + " ".join(f"{e:.3g}" for e in r["flash"])
                    + ", plain fp32 " + " ".join(f"{e:.3g}"
                                                  for e in r["plain32"])
                    for i, r in enumerate(moe_flash))
        + f" (limits {PP_TOL['flash_fwd']}, {PP_TOL['flash_bwd']} or "
        f"{MOE_SPREAD}x plain fp32's); {smi}")
    if moe_failed:
        raise AssertionError("; ".join(moe_failed))
    log(f"[moe] (d) bf16 routing, {MOE_BF16_TOKENS} tokens a rank to "
        f"expert 0 (capacity {bf[0]['cap']}): kept max err "
        f"{max(b['kept_err'] for b in bf):.3g} (tol {PP_TOL['bf16_kept']}),"
        f" dropped tokens nonzero {sum(b['dropped_nonzero'] for b in bf)}; "
        f"phase 46 {wall:.1f} s after its release (rank 0's parts done at "
        f"{json.dumps({k: round(v, 1) for k, v in r0['s'].items()})} s); "
        f"{smi}")
    launches = {}
    for m in moe.values():
        for lc in m["launches"]:
            for name, v in lc.items():
                launches[name] = launches.get(name, 0) + v
    record = {"pp": pp, "apply_tree": at, "memory": mem, "moe": moe,
              "moe_flash": moe_flash, "bf16": bf, "s": wall, "rank_s": [r0["s"], r1["s"]]}
    return record, launches


# ------------------------------------------------------------ phase 47
# Module and KVStore across ranks (ROADMAP Queue 1 item 10b, slice 3):
# (a) phase 40's workers (DIST_WORKER: its seeds, batches and SGD)
# launched with -s 0, so kv.create("dist_sync") is the collective store
# over the two ranks sharing the card (gloo), once replicated
# (MXTPU_SHARD_UPDATE=0) and once sharded (=1); (b) one process at world
# 1 against the device store; (c) rides phase 45 (b)'s (2, 1) pair (a
# second run of its mesh with the fused metric window and MXTPU_SENTINEL
# on); (d) group2ctx on examples/model-parallel-lstm/lstm_ptb.py's graph
# at its default sizes, and a graph split between the card and the host.
COLL_TIMEOUT_S = 600
COLL_MODULE_STEPS = 3            # (b)
# (a) against phase 40's parameter-server weights: equal to the bit, or
# within COLL_SPREAD times the fp32 oracle's own distance from an fp64
# oracle (the same SGD from worker 0's weights in fp64), the Rules' way
# of bounding fp32 rounding carried by SGD; the state bytes a rank of
# the sharded run within one padding element a slot of half the
# replicated run's
COLL_SPREAD = 4.0
# (d): lstm_ptb.py's defaults (num_layers 2, seq 16, vocab 1000, hidden
# and embedding 128, batch 16) and its lr, 3 steps
MP_LSTM = dict(num_layers=2, seq_len=16, vocab_size=1000, num_hidden=128,
               num_embed=128)
MP_LSTM_BATCH, MP_LSTM_STEPS, MP_LSTM_LR = 16, 3, 0.1


def mp_lstm_symbol(num_layers, seq_len, vocab_size, num_hidden, num_embed,
                   group_per_layer):
    """The port's copy of ``examples/model-parallel-lstm/lstm_ptb.py``'s
    ``model_parallel_lstm``: each layer's nodes in its ``ctx_group``
    (``tests/test_torch_collective.py`` holds its JSON to the
    example's)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import sym
    from mxnet_tpu_torch.models.lstm import LSTMParam, LSTMState, lstm

    with mx.AttrScope(ctx_group="embed"):
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        embed_weight = sym.Variable("embed_weight")
        embed = sym.Embedding(data, weight=embed_weight,
                              input_dim=vocab_size, output_dim=num_embed,
                              name="embed")
        slices = sym.SliceChannel(embed, num_outputs=seq_len, axis=1,
                                  squeeze_axis=True)
    params, states = [], []
    for layer in range(num_layers):
        with mx.AttrScope(ctx_group=group_per_layer[layer]):
            params.append(LSTMParam(
                i2h_weight=sym.Variable(f"l{layer}_i2h_weight"),
                i2h_bias=sym.Variable(f"l{layer}_i2h_bias"),
                h2h_weight=sym.Variable(f"l{layer}_h2h_weight"),
                h2h_bias=sym.Variable(f"l{layer}_h2h_bias")))
            states.append(LSTMState(c=sym.Variable(f"l{layer}_init_c"),
                                    h=sym.Variable(f"l{layer}_init_h")))
    outputs = []
    for t in range(seq_len):
        x = slices[t]
        for layer in range(num_layers):
            with mx.AttrScope(ctx_group=group_per_layer[layer]):
                states[layer] = lstm(num_hidden, x, states[layer],
                                     params[layer], t, layer)
                x = states[layer].h
        outputs.append(x)
    with mx.AttrScope(ctx_group="out"):
        concat = sym.Concat(*outputs, dim=0)
        pred = sym.FullyConnected(concat, num_hidden=vocab_size, name="pred")
        label_t = sym.transpose(label)
        label_flat = sym.Reshape(label_t, shape=(-1,))
        return sym.SoftmaxOutput(pred, label_flat, name="softmax")


COLL_PROBE_ELEMS = 25_600_000   # ResNet-50's ~25.6 M fp32 gradients


def _gloo_probe(rank):
    """The collectives of the collective store on CUDA tensors between
    the two ranks sharing the card (gloo): each one's result against the
    expected value and its wall (ms, one call after a barrier, the card
    synchronised around it) on ``COLL_PROBE_ELEMS`` fp32 elements (an
    all-gather of half as many from each rank).  One more reduce-scatter
    sums ``arange + 100 * rank``, whose exact reference is the two-term
    sum as fp32 rounds it: its ``ref_mismatches`` counts the elements
    where ``2 * arange + 100``, a reference that rounds differently above
    2^24, would call the result wrong (all in rank 1's half).  Every
    rank calls it."""
    import torch.distributed as td

    from mxnet_tpu_torch.parallel import dist as pdist

    n = COLL_PROBE_ELEMS
    base = (torch.arange(n, device="cuda") % 1024).float()
    x = base + 1024 * rank               # exact in fp32
    total = 2 * base + 1024              # rank 0's plus rank 1's
    half = n // 2
    mine = slice(rank * half, (rank + 1) * half)
    ar = torch.arange(n, dtype=torch.float32, device="cuda")
    pair_sum = ar + (ar + 100)           # rank 0's plus rank 1's
    rounded_ref = (ar * 2 + 100)[mine]

    def a2a():
        out = torch.empty_like(x)
        td.all_to_all_single(out, x)
        return out

    cases = {
        "all_reduce": (lambda: pdist.all_reduce(x.clone()),
                       lambda o: torch.equal(o, total)),
        "reduce_scatter_tensor": (
            lambda: pdist.reduce_scatter(x),
            lambda o: torch.equal(o, total[rank * half:(rank + 1) * half])),
        "all_gather_into_tensor": (
            lambda: pdist.all_gather(x[:half]),
            lambda o: torch.equal(o, torch.cat([base[:half],
                                                base[:half] + 1024]))),
        "reduce_scatter_arange": (
            lambda: pdist.reduce_scatter(ar + 100 * rank),
            lambda o: torch.equal(o, pair_sum[mine])),
        "broadcast": (lambda: pdist.broadcast(x.clone(), 0),
                      lambda o: torch.equal(o, base)),
        "all_to_all_single": (
            a2a, lambda o: torch.equal(o[:half], base[rank * half:(rank + 1)
                                                      * half])
            and torch.equal(o[half:], base[rank * half:(rank + 1) * half]
                            + 1024)),
    }
    out = {}
    for name, (run, check) in cases.items():
        torch.cuda.synchronize()
        td.barrier()
        t0 = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        out[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                     "equal": bool(check(got))}
        if name == "reduce_scatter_arange":
            out[name]["ref_mismatches"] = int((got != rounded_ref).sum())
    return out


def _coll_start(root):
    """Starts (a)'s world now: ``python -m mxnet_tpu_torch.launch -n 2 -s
    0`` on ``DIST_WORKER``, whose ranks import, bind, initialise and meet
    beside earlier work, then train once the go file exists, with
    ``MXTPU_SHARD_UPDATE`` 0 and then 1 from the same seeds.  Returns
    ``(launcher, out dir, go file)``."""
    repo = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(root, "dist_worker.py")
    with open(script, "w") as f:
        f.write(DIST_WORKER)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXTPU_", "DMLC_"))}
    go = os.path.join(root, "go")
    env.update(PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p),
        DIST_MODE="sync", NVIDIA_TF32_OVERRIDE="0", DIST_OUT=root,
        DIST_GO=go, DIST_SHARDS="0,1")
    with open(os.path.join(root, "launch.log"), "w") as log_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2",
             "-s", "0", "--launcher", "local", sys.executable, script],
            env=env, cwd=repo, stdout=log_f, stderr=subprocess.STDOUT,
            start_new_session=True)
    return proc, root, go


def _coll_kill(world):
    import signal

    if world[0].poll() is None:
        os.killpg(world[0].pid, signal.SIGKILL)


def _coll_run(world):
    """Release :func:`_coll_start`'s world and wait for it; returns
    ``({shard: the two ranks' results}, [each rank's gloo probe], wall
    s)``."""
    proc, out, go = world
    t0 = time.perf_counter()
    open(go, "w").close()
    try:
        proc.wait(timeout=COLL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        _coll_kill(world)
        proc.wait()
    wall = time.perf_counter() - t0
    with open(os.path.join(out, "launch.log")) as f:
        text = f.read()
    if proc.returncode != 0:
        raise AssertionError(f"collective (a): the launch exited "
                             f"{proc.returncode}:\n{text[-6000:]}")
    runs = {shard: [_dist_result(out, f"sync{r}s{shard}") for r in range(2)]
            for shard in ("0", "1")}
    probe = []
    for r in range(2):
        with open(os.path.join(out, f"probe_{r}.json")) as f:
            probe.append(json.load(f))
    return runs, probe, wall


def _dist_oracle64(names, w0):
    """Phase 40's one-process oracle in fp64: both shards' gradients
    summed each step, the same SGD (the port's updater on fp64 tensors)
    from worker 0's weights, NCHW (cuDNN's fp64 convolutions);
    ``{step: weights}`` after steps 1 and ``DIST_STEPS``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.executor import simple_bind
    from mxnet_tpu_torch.models import resnet

    net = resnet.get_symbol(num_classes=1000, num_layers=50,
                            image_shape=(3, 224, 224))
    f64 = torch.float64
    types = {n: f64 for n in net.list_arguments()
             + net.list_auxiliary_states()}
    req = {n: ("write" if n in names else "null")
           for n in net.list_arguments()}
    ex = _with_env({"MXTPU_CONV_LAYOUT": "NCHW"}, lambda: simple_bind(
        net, mx.gpu(0), grad_req=req, type_dict=types,
        data=(DIST_BATCH, 3, 224, 224), softmax_label=(DIST_BATCH,)))
    for n in names:
        ex.arg_dict[n].copy_(w0[n].to(f64))
    # the Module's optimizer: its names give the biases and BN's gamma
    # and beta no weight decay
    upd = mx.optimizer.get_updater(mx.optimizer.create(
        "sgd", sym=net, param_idx2name=dict(enumerate(names)),
        rescale_grad=1.0 / (2 * DIST_BATCH), **DIST_OPT))
    shards = [_dist_shard(r, DIST_STEPS) for r in range(2)]
    out = {}
    for k in range(DIST_STEPS):
        acc = None
        for r in range(2):
            x, y = shards[r][k]
            ex.forward(is_train=True, data=x.to(f64), softmax_label=y)
            ex.backward()
            g = {n: ex.grad_dict[n].clone() for n in names}
            acc = g if acc is None else {n: acc[n] + g[n] for n in names}
        for i, n in enumerate(names):
            upd(i, mx.nd.NDArray(acc[n]), mx.nd.NDArray(ex.arg_dict[n]))
        if k + 1 in (1, DIST_STEPS):
            out[k + 1] = {n: ex.arg_dict[n].detach().cpu() for n in names}
    del ex, shards
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _coll_vs_ps(ws, ps, ora64):
    """(a)'s weights against phase 40's at steps 1 and ``DIST_STEPS``:
    bit-equal parameters, relative errors (max, median) against the PS
    run and against the fp64 oracle beside the fp32 oracle's and the PS
    run's own from fp64, and whether each lies within ``COLL_SPREAD``
    times the fp32 oracle's distance."""
    rows = {}
    for step in (1, DIST_STEPS):
        got = ws[step]
        ref = {n: ora64[step][n].float() for n in got}
        equal = sum(int(torch.equal(got[n], ps[step][n])) for n in got)
        vs_ps = _rel_errs(got, ps[step])
        o32 = _rel_errs(ps["oracle32"][step], ref)
        rows[step] = {
            "bit_equal_params": equal, "params": len(got),
            "vs_ps": vs_ps, "vs_fp64": _rel_errs(got, ref),
            "fp32_oracle_vs_fp64": o32,
            "ps_vs_fp64": _rel_errs(ps[step], ref),
            "within": equal == len(got) or (
                vs_ps[0] <= COLL_SPREAD * o32[0]
                and vs_ps[2] <= COLL_SPREAD * o32[2])}
    return rows


def _coll_world1(smi):
    """(b): one process, ``Module`` over ``[gpu(0)]`` through
    ``kv.create("dist_sync")`` (the collective store at world 1: no
    servers, no launcher) against ``kv.create("device")``, from the same
    seeded weights on worker 0's batches: the weights after each step
    equal to the bit."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import resnet

    net = resnet.get_symbol(num_classes=1000, num_layers=50,
                            image_shape=(3, 224, 224))
    shards = _dist_shard(0, COLL_MODULE_STEPS)
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    runs = {}
    try:
        for name in ("dist_sync", "device"):
            mx.random.seed(0)
            mod = mx.mod.Module(net, context=[mx.gpu(0)])
            mod.bind(data_shapes=[("data", (DIST_BATCH, 3, 224, 224))],
                     label_shapes=[("softmax_label", (DIST_BATCH,))])
            mod.init_params(initializer=mx.init.Xavier())
            kv = mx.kv.create(name)
            mod.init_optimizer(kvstore=kv, optimizer="sgd",
                               optimizer_params=DIST_OPT)
            ex = mod._exec_group.execs[0]
            weights = [ex.arg_dict[n] for n in mod._param_names]
            digests = []
            for x, y in shards:
                mod.forward_backward(_batch(x, y))
                mod.update()
                digests.append(_bits_digest(weights))
            runs[name] = {"digests": [str(int(d)) for d in digests],
                          "collective": kv.collective,
                          "workers": kv.num_workers,
                          "bucketed": kv._fused is not None}
            del mod, ex, weights
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = flags
    c = runs["dist_sync"]
    if not (c["collective"] and c["workers"] == 1 and c["bucketed"]):
        raise AssertionError(f"collective (b): the store {c}")
    if c["digests"] != runs["device"]["digests"]:
        raise AssertionError(f"collective (b): dist_sync at world 1 parts "
                             f"from the device store: {runs}")
    log(f"[collective] (b) Module over [gpu(0)], ResNet-50 b{DIST_BATCH} "
        f"fp32 SGD, kv.create('dist_sync') with no servers and no launcher "
        f"(collective={c['collective']}, {c['workers']} worker, bucketed "
        f"engine) against kv.create('device'): the weights after each of "
        f"{COLL_MODULE_STEPS} steps equal to the bit; {smi}")
    return runs


def _mp_lstm_run(net, group2ctx, data, label):
    """``lstm_ptb.py``'s loop on ``net`` bound with ``group2ctx``: 3 SGD
    steps from seeded weights; the outputs and gradients of each step
    and the devices the arguments were bound on."""
    import mxnet_tpu_torch as mx

    shapes = {"data": data.shape, "softmax_label": label.shape}
    for layer in range(MP_LSTM["num_layers"]):
        for s in ("c", "h"):
            shapes[f"l{layer}_init_{s}"] = (MP_LSTM_BATCH,
                                             MP_LSTM["num_hidden"])
    ex = net.simple_bind(mx.gpu(0), group2ctx=group2ctx, **shapes)
    mx.random.seed(0)
    init = mx.init.Xavier(magnitude=2.34)
    for name in sorted(ex.arg_dict):
        if name not in shapes:
            init(name, ex.arg_dict[name])
    outs, grads = [], []
    for _ in range(MP_LSTM_STEPS):
        ex.forward(is_train=True, data=data, softmax_label=label)
        ex.backward()
        outs.append(ex.outputs[0].clone())
        grads.append({k: g.clone() for k, g in ex.grad_dict.items()})
        for k, g in ex.grad_dict.items():
            if k not in shapes:
                ex.arg_dict[k].sub_(MP_LSTM_LR * g)
    devices = sorted({str(t.device) for t in ex.arg_dict.values()})
    return outs, grads, devices


# (d)'s card/host split: rows, inputs and hidden units of a
# FullyConnected on the card whose 64 MB output crosses to host ops
G2C_SPLIT = (4096, 2048, 4096)


def g2c_split_run(group2ctx):
    """A FullyConnected in group ``card`` feeding ``relu(fc) * s + s`` in
    group ``host``, bound on ``gpu(0)`` with ``group2ctx`` (or without
    groups): one forward and backward from seeded values.  Returns the
    output and the gradients on the host, and the devices of the output
    and of ``s``.  The host's ops are exactly rounded, so any split
    gives the unplaced graph's bits unless a crossing hands the host a
    buffer the card has not filled yet."""
    import mxnet_tpu_torch as mx

    n, d, h = G2C_SPLIT
    data = mx.sym.Variable("data")
    with mx.AttrScope(ctx_group="card"):
        fc = mx.sym.FullyConnected(data, num_hidden=h, name="fc")
    with mx.AttrScope(ctx_group="host"):
        s = mx.sym.Variable("s")
        net = mx.sym.Activation(fc, act_type="relu") * s + s
    ex = net.simple_bind(mx.gpu(0), group2ctx=group2ctx, data=(n, d),
                         s=(n, h))
    g = torch.Generator().manual_seed(0)
    for k in sorted(ex.arg_dict):
        ex.arg_dict[k].copy_(torch.randn(ex.arg_dict[k].shape, generator=g))
    ex.forward(is_train=True)
    out = ex.outputs[0]
    ex.backward([torch.ones(out.shape, device=out.device)])
    return (out.cpu(), {k: v.cpu() for k, v in ex.grad_dict.items()},
            (str(out.device), str(ex.arg_dict["s"].device)))


def _g2c_split(smi):
    """(d)'s split across devices: ``{'card': gpu(0), 'host': cpu()}``
    against the graph without groups, output and gradients equal to the
    bit (the card-to-host crossing blocks until its values are there)."""
    import mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    placed = g2c_split_run({"card": mx.gpu(0), "host": mx.cpu()})
    plain = g2c_split_run(None)
    bad = [] if torch.equal(placed[0], plain[0]) else ["output"]
    bad += [k for k in plain[1] if not torch.equal(placed[1][k],
                                                   plain[1][k])]
    if bad or placed[2] != ("cpu", "cpu"):
        raise AssertionError(f"collective (d): the card/host split parts "
                             f"from the graph without groups at {bad}, "
                             f"output and s on {placed[2]}")
    log(f"[collective] (d) group2ctx {{'card': gpu(0), 'host': cpu()}}: "
        f"FullyConnected {G2C_SPLIT[0]}x{G2C_SPLIT[1]} -> {G2C_SPLIT[2]} "
        f"on the card, relu(fc) * s + s on the host, forward and backward "
        f"equal to the bit to the graph on gpu(0) without groups (output "
        f"and gradients of data, fc_weight, fc_bias, s); output and s on "
        f"{placed[2]}; {time.perf_counter() - t0:.1f} s; {smi}")
    return {"split": list(G2C_SPLIT), "devices": list(placed[2])}


def _mp_lstm(smi):
    """(d): ``group2ctx`` on the model-parallel LSTM's graph, every group
    on ``gpu(0)`` (the one card), against the same graph bound without
    groups: outputs and gradients equal to the bit at each step; then a
    graph split between the card and the host (:func:`_g2c_split`)."""
    import mxnet_tpu_torch as mx

    groups = [f"layer{i}" for i in range(MP_LSTM["num_layers"])]
    net = mp_lstm_symbol(group_per_layer=groups, **MP_LSTM)
    g = torch.Generator().manual_seed(0)
    data = torch.randint(0, MP_LSTM["vocab_size"],
                         (MP_LSTM_BATCH, MP_LSTM["seq_len"]),
                         generator=g).float().cuda()
    label = torch.randint(0, MP_LSTM["vocab_size"],
                          (MP_LSTM_BATCH, MP_LSTM["seq_len"]),
                          generator=g).float().cuda()
    g2c = {"embed": mx.gpu(0), "out": mx.gpu(0)}
    g2c.update({grp: mx.gpu(0) for grp in groups})
    t0 = time.perf_counter()
    placed = _mp_lstm_run(net, g2c, data, label)
    plain = _mp_lstm_run(net, None, data, label)
    torch.cuda.synchronize()
    bad = [i for i, (a, b) in enumerate(zip(placed[0], plain[0]))
           if not torch.equal(a, b)]
    bad += [f"{i}:{k}" for i, (ga, gb) in enumerate(zip(placed[1],
                                                        plain[1]))
            for k in gb if not torch.equal(ga[k], gb[k])]
    if bad or placed[2] != [str(mx.gpu(0))]:
        raise AssertionError(f"collective (d): group2ctx parts from the "
                             f"graph without groups at {bad[:5]}, devices "
                             f"{placed[2]}")
    log(f"[collective] (d) group2ctx on lstm_ptb.py's graph "
        f"({MP_LSTM['num_layers']} layers, seq {MP_LSTM['seq_len']}, vocab "
        f"{MP_LSTM['vocab_size']}, hidden {MP_LSTM['num_hidden']}, batch "
        f"{MP_LSTM_BATCH}), groups {sorted(g2c)} all on gpu(0): outputs and "
        f"gradients of {MP_LSTM_STEPS} SGD steps equal to the bit to the "
        f"graph bound without groups; arguments on {placed[2]}; "
        f"{time.perf_counter() - t0:.1f} s; {smi}")
    return {"steps": MP_LSTM_STEPS, "devices": placed[2],
            "host_split": _g2c_split(smi)}


def _coll_a(smi, world, ps):
    """(a): the world's two runs, then the checks."""
    runs, probe, wall = _coll_run(world)
    for shard, res in runs.items():
        for r in res:
            if not (r["collective"] and r["num_workers"] == 2):
                raise AssertionError(f"collective (a) shard={shard}: rank "
                                     f"{r['rank']}'s store {r}")
        if res[0]["digests"] != res[1]["digests"] or \
                len(res[0]["digests"]) != DIST_STEPS + 1:
            raise AssertionError(f"collective (a) shard={shard}: the "
                                 f"ranks' weights part: {res[0]['digests']}"
                                 f" vs {res[1]['digests']}")
        if res[0]["local_digest"] == res[1]["local_digest"]:
            raise AssertionError("collective (a): both ranks initialised "
                                 "alike; the broadcast is not tested")
        want = {"0": [1], "1": [2]}[shard]
        if any(r["shard_n"] != want for r in res):
            raise AssertionError(f"collective (a) shard={shard}: buckets "
                                 f"sharded {[r['shard_n'] for r in res]}")
        syncs = [r["step_syncs"] for r in res]
        if any(any(s) for s in syncs):
            raise AssertionError(f"collective (a) shard={shard}: host syncs "
                                 f"a batch {syncs}")
    if runs["0"][0]["digests"] != runs["1"][0]["digests"]:
        raise AssertionError("collective (a): the sharded update parts from "
                             "the replicated one")
    if not all(v["equal"] for p in probe for v in p.values()):
        raise AssertionError(f"collective (a): gloo on CUDA tensors: {probe}")
    log(f"[collective] (a) gloo on CUDA tensors, two ranks sharing the card, "
        f"{COLL_PROBE_ELEMS * 4 / 1e6:.1f} MB fp32 (an all-gather of half "
        f"from each rank), every result as expected, ms (rank 0, rank 1): "
        + ", ".join(f"{k} {probe[0][k]['ms']:.1f} {probe[1][k]['ms']:.1f}"
                    for k in probe[0])
        + "; arange + 100 * rank reduce-scattered equals the two-term sum "
        f"as fp32 rounds it, and differs from 2 * arange + 100 at "
        f"{[p['reduce_scatter_arange']['ref_mismatches'] for p in probe]} "
        f"elements (rank 0, rank 1); {smi}")
    order = ps["order"]
    ws = {step: {n: torch.from_numpy(v) for n, v in _npz(
        world[1], f"w{step}_sync0s1").items()}
        for step in (0, 1, DIST_STEPS)}
    w0_equal = all(torch.equal(ws[0][n], ps[0][n]) for n in order)
    if not w0_equal:
        raise AssertionError("collective (a): worker 0's initial weights "
                             "differ from phase 40's")
    t64 = time.perf_counter()
    ora64 = _dist_oracle64(order, ps[0])
    t64 = time.perf_counter() - t64
    rows = _coll_vs_ps(ws, ps, ora64)
    del ora64
    for step, row in rows.items():
        if not row["within"]:
            raise AssertionError(f"collective (a): step {step} against "
                                 f"phase 40's weights {row}")
    rep, shd = runs["0"][0], runs["1"][0]
    half = rep["state_bytes"] / 2
    slack = 4 * rep["buckets"] * 8   # a padding element a slot a bucket
    if not half <= shd["state_bytes"] <= half + slack:
        raise AssertionError(f"collective (a): optimizer state bytes a rank "
                             f"{shd['state_bytes']} against the replicated "
                             f"{rep['state_bytes']}")
    lo = DIST_TIMED_FROM
    per = {}
    for shard, res in runs.items():
        ms = []
        for r in res:
            span = r["t_in"][-1] - r["t_out"][lo - 1]
            cbs = sum(o - i for i, o in zip(r["t_in"][lo:-1],
                                            r["t_out"][lo:-1]))
            ms.append((span - cbs) / (DIST_STEPS - lo) * 1e3)
        p = res[0]["profile"]
        per[shard] = {
            "step_ms": max(ms), "img_s": 2 * DIST_BATCH / max(ms) * 1e3,
            "allreduce_mb_step": res[0]["allreduce_bytes"] / DIST_STEPS / 1e6,
            "collective_mb_step": {k: v / DIST_STEPS / 1e6 for k, v in
                                   res[0]["collective_bytes"].items()},
            "state_mb": res[0]["state_bytes"] / 1e6,
            "peak_gib": max(r["peak_bytes"] for r in res) / 2 ** 30,
            "busy_ms_rank0": p["busy_ms"], "wall_ms_rank0": p["wall_ms"],
            "idle_share_rank0": 1 - p["busy_ms"] / p["wall_ms"],
            "window_waits": res[0]["window_waits"],
            # rank 0: its start to the store being ready (bind, init,
            # the broadcasts; before the go file for the first run), the
            # go to the last step, to the result
            "start_to_ready_s": res[0]["t_ready"] - res[0]["t_start"],
            "go_to_fit_end_s": res[0]["walls"][-1] - res[0]["t_go"],
            "fit_end_to_result_s": res[0]["t_end"] - res[0]["walls"][-1],
            "launches": {k: res[0]["launches"][k] + res[1]["launches"][k]
                         for k in res[0]["launches"]}}
    log(f"[collective] (a) ResNet-50 b{DIST_BATCH}/rank x 2 ranks sharing "
        f"the card over gloo, fp32 SGD, Module.fit through the collective "
        f"dist_sync (launch -s 0), {DIST_STEPS} steps, phase 40's seeds and "
        f"batches: "
        + "; ".join(
            f"MXTPU_SHARD_UPDATE={s}: step {v['step_ms']:.1f} ms (steps "
            f"{lo + 1}-{DIST_STEPS}; {v['img_s']:.2f} img/s across both), "
            f"all-reduce/reduce-scatter {v['allreduce_mb_step']:.1f} MB a "
            f"step, collectives {json.dumps(v['collective_mb_step'])} MB a "
            f"step, optimizer state {v['state_mb']:.1f} MB a rank, peak "
            f"{v['peak_gib']:.2f} GiB, rank 0 busy {v['busy_ms_rank0']:.1f} "
            f"of {v['wall_ms_rank0']:.1f} ms (idle "
            f"{v['idle_share_rank0']:.3f})" for s, v in per.items())
        + f"; phase 40's PS step in its [dist_sync] line; walls (s): the "
        f"launch {wall:.1f} from the go file; "
        + "; ".join(f"shard={k}: to ready {v['start_to_ready_s']:.1f} "
                    f"from the rank's start, the go (or the last run) to "
                    f"the last step {v['go_to_fit_end_s']:.1f}, to the "
                    f"result {v['fit_end_to_result_s']:.1f}"
                    for k, v in per.items())
        + f"; the fp64 oracle {t64:.1f}; {smi}")
    log(f"[collective] (a) checks: both ranks' weights bit-equal after each "
        f"step; sharded == replicated to the bit; host syncs a batch "
        f"{runs['1'][0]['step_syncs']}; against phase 40's parameter-server "
        f"weights: "
        + "; ".join(f"step {k}: {v['bit_equal_params']}/{v['params']} "
                    f"params bit-equal, rel err max {v['vs_ps'][0]:.3g} "
                    f"({v['vs_ps'][1]}) median {v['vs_ps'][2]:.3g}; vs the "
                    f"fp64 oracle max {v['vs_fp64'][0]:.3g}, the fp32 "
                    f"oracle's {v['fp32_oracle_vs_fp64'][0]:.3g}, the PS "
                    f"run's {v['ps_vs_fp64'][0]:.3g}"
                    for k, v in rows.items()))
    return {"runs": per, "vs_ps": rows, "gloo_probe": probe, "launches": {
        k: sum(v["launches"][k] for v in per.values())
        for k in per["0"]["launches"]}}


def phase_collective(smi, ps, world, mesh_rec):
    """Phase 47: Module and KVStore across ranks (see the module
    docstring).  ``ps`` is phase 40's weights, ``world`` (a)'s started
    world, ``mesh_rec`` phase 45's record, whose (2, 1) pair is (c).
    Returns ``(record, launches of (a), (b) and (d) in this process and
    the ranks, (c)'s in its ranks)``."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches = _kernel_launches(reset=True)
    rec = {"a": _coll_a(smi, world, ps)}
    rec["b"] = _coll_world1(smi)
    rec["d"] = _mp_lstm(smi)
    here = _kernel_launches()
    c = mesh_rec["gloo"]["collective"]
    log(f"[collective] (c) phase 45 (b)'s (2, 1) pair, the LM at "
        f"{MESH_LAYERS} layers and full widths, bf16, {MESH_STEPS} steps "
        f"again after its run with the sentinel off, now with "
        f"MXTPU_SENTINEL=warn and a fused CrossEntropy over the global "
        f"batch: num_inst {c['num_inst']} a rank (the global batch's "
        f"{c['tokens']} tokens), metric {c['metric_mesh']:.6f} against the "
        f"run's own mean loss {c['metric_own'][0]:.6f} (worst rel "
        f"{c['metric_own_rel']:.3g}, limit {COLL_METRIC_OWN_TOL:.3g}) and "
        f"one process's {c['metric_plain']:.6f} (rel "
        f"{c['metric_rel']:.3g}), the "
        f"sentinel's norms {c['norms_mesh']} against {c['norms_plain']} "
        f"(worst rel {c['norm_rel']:.3g}), flags equal, the metric read "
        f"once ({c['metric_drains']} drain a rank); flash launches a rank "
        f"{c['launches_by_rank']}")
    launches = {k: here[k] + rec["a"]["launches"][k]
                + c["launches"].get(k, 0) for k in here}
    log(f"[collective] phase 47 {time.perf_counter() - t0:.1f} s; "
        f"hand-written kernel launches (a) {json.dumps(rec['a']['launches'])}"
        f", (b) and (d) {json.dumps(here)}, (c) {json.dumps(c['launches'])}")
    log(f"[collective] {json.dumps(rec)}")
    return rec, launches


def _pp_start(out_dir):
    """Starts phase 46's two ranks now: they import beside earlier work
    and touch the card once :func:`phase_pipeline_moe` releases them."""
    os.makedirs(out_dir, exist_ok=True)
    return _mesh_start("pp", out_dir, {"MESH_GO": os.path.join(
        out_dir, "go_pp")}, _free_ports(1)[0], worker=PIPE_WORKER)


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
_T0 = None                       # main's start, for the [timing] lines
_WALLS = []                      # (tag, s since the previous, s so far)


def _elapsed(tag):
    """Log the script's wall so far, after ``tag``: each phase's share of
    the time limit the whole script runs under."""
    now = time.perf_counter() - _T0
    _WALLS.append((tag, now - (_WALLS[-1][2] if _WALLS else 0.0), now))
    log(f"[timing] {tag} done at {now:.1f} s")


def _wall_table():
    """Every phase's wall and the script's so far, one row each, longest
    first after the running order."""
    lines = [f"[timing] table: {len(_WALLS)} phases, "
             f"{_WALLS[-1][2]:.1f} s in all (against a 1200 s limit)",
             f"[timing] {'phase':<44} {'s':>8} {'done at':>9}"]
    lines += [f"[timing] {tag:<44} {s:8.1f} {at:9.1f}"
              for tag, s, at in _WALLS]
    top = sorted(_WALLS, key=lambda w: -w[1])[:8]
    lines.append("[timing] longest: " + ", ".join(f"{t} {s:.1f} s"
                                                  for t, s, _ in top))
    for line in lines:
        log(line)


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
    global _T0
    _T0 = time.perf_counter()
    smi, ptxas = phase_device()
    _elapsed("phase_device")
    kern = phase_kernels()
    _elapsed("phase_kernels")
    flash, flash_builds = phase_flash_kernels(ptxas)
    _elapsed("phase_flash_kernels")
    paged_build = paged_build_record(ptxas["paged_attention"])
    log(f"[build] paged_attention (registers and spills: split, combine): "
        f"{json.dumps(paged_build)}")
    # slice 16's C programs (phases 37-38) run here, while this process
    # holds little of the card: each child needs its own ~5 and ~20 GB,
    # which the cache of the later phases, fragmented by their live
    # tensors, would not leave free.  Each phase reads its own main
    # path's counts.  Slice 20's C and Perl clients (phase 44 (d)-(e)) go
    # with them, for the same reason (the Perl child needs its own few
    # GB): the four clients and the import probe run side by side, each
    # phase's work in this process after they all ended
    slice16, slice20 = {}, {}
    (_, slice16["c_predict"]), (_, slice16["c_api"]), \
        (_, slice20["amalgamation"]) = _side_by_side([
            phase_c_predict(smi), phase_c_api(smi), phase_amalgamation(smi)])
    _elapsed("phases c_predict, c_api, amalgamation")
    # slice 17's workers (phases 40-41) each need ~7 GiB of their own:
    # next to 37-38, for the same reason
    slice17 = {}
    _, slice17["dist_sync"], ps_weights = phase_dist_sync(smi)
    _elapsed("phase_dist_sync")
    _, slice17["dist_async"] = phase_dist_async(smi)
    _elapsed("phase_dist_async")
    log(f"[slice17] hand-written kernel launches by phase: "
        f"{json.dumps(slice17)}")
    # slice 21's mesh (phase 45) next to them: its two-rank children need
    # card memory of their own too; each part reads its own counts.
    # Slice 22's pair (phase 46) and slice 23's world (phase 47 (a)) start
    # now, import (and the world binds) beside phase 45 and run after it
    pp_dir = tempfile.TemporaryDirectory()
    coll_dir = tempfile.TemporaryDirectory()
    pp_procs = _pp_start(pp_dir.name)
    coll_world = _coll_start(coll_dir.name)
    try:
        mesh_rec, mesh_launches = phase_mesh(smi)
        _elapsed("phase_mesh")
        _, pp_launches = phase_pipeline_moe(smi, pp_procs, pp_dir.name)
        _elapsed("phase_pipeline_moe")
        _, coll_launches = phase_collective(smi, ps_weights, coll_world,
                                            mesh_rec)
        _elapsed("phase_collective")
    finally:
        _mesh_kill(pp_procs)
        _coll_kill(coll_world)
        pp_dir.cleanup()
        coll_dir.cleanup()
    del ps_weights
    log(f"[slice21] hand-written kernel launches in phase 45 (a): "
        f"{json.dumps(mesh_launches)}; (b) in the gloo ranks: "
        f"{json.dumps(mesh_rec['gloo_launches'])}")
    log(f"[slice22] hand-written kernel launches in phase 46 (c), summed "
        f"over the two ranks: {json.dumps(pp_launches)}")
    log(f"[slice23] hand-written kernel launches in phase 47, (c)'s summed "
        f"over its two ranks: {json.dumps(coll_launches)}")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if not mesh_launches[name]:
            raise AssertionError(f"phase 45: {name} never launched")
        if not pp_launches.get(name):
            raise AssertionError(f"phase 46: {name} never launched")
        if not coll_launches.get(name):
            raise AssertionError(f"phase 47: {name} never launched")
    cfg, params = _params(seed=0)
    launches, tick = phase_serve(cfg, params)
    _elapsed("phase_serve")
    phase_parity(cfg, params)
    _elapsed("phase_parity")
    flash_launches, train = phase_train()
    _elapsed("phase_train")
    # recompute runs the same cell: next to it, before the image phases
    # fill the allocator's cache
    remat_launches, remat = phase_remat(smi)
    _elapsed("phase_remat")
    # the profiled step is the same cell again
    prof, prof_launches = phase_profiler(smi)
    _elapsed("phase_profiler")
    phase_train_resnet(smi)
    _elapsed("phase_train_resnet")
    module = phase_module_resnet(smi)
    _elapsed("phase_module_resnet")
    module_amp = phase_module_amp(smi, module)
    _elapsed("phase_module_amp")
    # FeedForward and the Custom head run phase_module_resnet's cell (50
    # GiB at batch 256): next to it, before later phases fragment the
    # allocator's cache.  The epilogue runs in FeedForward's score and
    # predict, no hand-written kernel under the Custom head
    ff, ff_state, ff_launches = phase_feedforward(smi)
    _elapsed("phase_feedforward")
    custom, custom_launches = phase_custom_op(smi, ff_state, ff["fit"])
    _elapsed("phase_custom_op")
    del ff_state
    # phase 42's Module half runs the same cell: next to it, for the same
    # reason (its LM half, Predictor and exporters run last)
    gc.collect()
    torch.cuda.empty_cache()
    core_module = _core_module(smi)
    _elapsed("_core_module")
    epi, epi_launches = phase_predict()
    _elapsed("phase_predict")
    ckpt = phase_checkpoint()
    _elapsed("phase_checkpoint")
    rtc_kernels, rtc_launches = phase_rtc(ckpt["logits"], ckpt["n_params"])
    _elapsed("phase_rtc")
    phase_train_inception(smi)
    _elapsed("phase_train_inception")
    phase_module_alexnet(smi)
    _elapsed("phase_module_alexnet")
    zoo = phase_zoo_score(smi)
    _elapsed("phase_zoo_score")
    # the LSTM LM's path runs no hand-written kernel: the counts stay 0
    lstm_launches = _kernel_launches(reset=True)
    phase_train_lstm(smi)
    _elapsed("phase_train_lstm")
    phase_bucketing_lstm(smi)
    _elapsed("phase_bucketing_lstm")
    lstm_launches = _kernel_launches()
    log(f"[lstm] hand-written kernel launches in phases 12-13: "
        f"{json.dumps(lstm_launches)}")
    # training from RecordIO: the epilogue runs in score.py's sweeps only
    rec_launches = _kernel_launches(reset=True)
    # the records stay for phase_native's rerun with telemetry on
    rec_dir = tempfile.TemporaryDirectory()
    workdir = rec_dir.name
    recs = phase_records(smi, workdir)
    _elapsed("phase_records")
    iters = phase_record_iter(smi, recs)
    _elapsed("phase_record_iter")
    train_rec = phase_train_records(smi, recs)
    _elapsed("phase_train_records")
    module_rec = phase_module_records(smi, recs)
    _elapsed("phase_module_records")
    phase_sequential(smi, workdir)
    _elapsed("phase_sequential")
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
    _elapsed("phase_sparse_mf")
    phase_sparse_update(smi)
    _elapsed("phase_sparse_update")
    sparse_launches = _kernel_launches()
    if any(sparse_launches.values()):
        raise AssertionError(f"phases 19-20 launched {sparse_launches}")
    survival = phase_survival(smi)
    _elapsed("phase_survival")
    phase_kill_resume(smi)
    _elapsed("phase_kill_resume")
    # slice 13: int8 serving, the generation loops, the router, int8
    # inference; each phase reads its own main path's counts
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params = _params(seed=0, layers=LATE_LM_LAYERS)
    slice13 = {}
    slice13["serve_int8"], dec16 = phase_serve_int8(cfg, params, smi)
    _elapsed("phase_serve_int8")
    slice13["generate"] = phase_generate(cfg, dec16, smi)
    _elapsed("phase_generate")
    del dec16
    slice13["router"] = phase_router(cfg, params, smi)
    _elapsed("phase_router")
    del params
    slice13["predict_int8"] = phase_predict_int8(smi)
    _elapsed("phase_predict_int8")
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
    _elapsed("phase_ssd_train")
    phase_ssd_detect(smi, ssd_params, ssd_data)
    _elapsed("phase_ssd_detect")
    del ssd_params, ssd_data
    phase_rcnn(smi)
    _elapsed("phase_rcnn")
    phase_ocr(smi)
    _elapsed("phase_ocr")
    det_launches = _kernel_launches()
    log(f"[detection] hand-written kernel launches in phases 31-34: "
        f"{json.dumps(det_launches)}")
    if any(det_launches.values()):
        raise AssertionError(f"phases 31-34 launched {det_launches}")
    # slice 15: the autotuner, then the health and perf planes, on the
    # LM's weights again
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params = _params(seed=0, layers=LATE_LM_LAYERS)
    _, tune_launches = phase_autotune(smi, cfg, params)
    _elapsed("phase_autotune")
    gc.collect()
    torch.cuda.empty_cache()
    _, plane_launches = phase_planes(smi, cfg, params)
    _elapsed("phase_planes")
    del params
    log(f"[slice15] hand-written kernel launches: autotune "
        f"{json.dumps(tune_launches)}; planes {json.dumps(plane_launches)}")
    # slice 16: the native runtime and the data iterators' telemetry
    # (phases 37-38 ran after phase 2)
    _, slice16["native"] = phase_native(smi, recs, iters["img_s"])
    _elapsed("phase_native")
    # slice 19: the records into a loopback S3 double, ResNet-50 trained
    # from it and checkpointed into it, the plugins (phase 43)
    gc.collect()
    torch.cuda.empty_cache()
    remote_launches = _kernel_launches(reset=True)
    phase_remote_plugins(smi, recs)
    remote_launches = _kernel_launches()
    _elapsed("phase_remote_plugins")
    rec_dir.cleanup()
    log(f"[slice19] hand-written kernel launches in phase 43: "
        f"{json.dumps(remote_launches)}")
    if not remote_launches["residual_epilogue"]:
        raise AssertionError("phase 43: the epilogue never launched")
    if not slice16["c_predict"]["residual_epilogue"]:
        raise AssertionError("c_predict: the epilogue never launched")
    log(f"[slice16] hand-written kernel launches by phase: "
        f"{json.dumps(slice16)}")
    # slice 18: the core telemetry families (phase 42)
    gc.collect()
    torch.cuda.empty_cache()
    _, core_launches = phase_core_telemetry(smi, cfg, core_module)
    _elapsed("phase_core_telemetry")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "residual_epilogue"):
        if not core_launches[name]:
            raise AssertionError(f"phase 42: {name} never launched")
    # slice 20: the port lint, the sync primitives against the card and
    # the entry points' witnesses (phase 44 (a)-(c)), after every phase
    # it cites
    gc.collect()
    torch.cuda.empty_cache()
    _, slice20["port_lint"] = phase_port_lint(smi)
    _elapsed("phase_port_lint")
    log(f"[slice20] hand-written kernel launches by phase: "
        f"{json.dumps(slice20)}")
    if slice20["amalgamation"]["residual_epilogue"] != 4 * AMAL_FORWARDS:
        raise AssertionError("phase 44: the epilogue's launches through "
                             "the amalgamated library")
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
                            *slice17.items(), *slice20.items()):
            rec[f"launches_{tag}"] = counts[rec["name"]]
        rec["launches_detection"] = det_launches[rec["name"]]
        rec["launches_autotune"] = tune_launches[rec["name"]]
        rec["launches_planes"] = plane_launches[rec["name"]]
        rec["launches_core_telemetry"] = core_launches[rec["name"]]
        rec["launches_remote_io"] = remote_launches[rec["name"]]
        rec["launches_mesh"] = mesh_launches[rec["name"]]
        rec["launches_mesh_gloo"] = mesh_rec["gloo_launches"].get(
            rec["name"], 0)
        rec["launches_pipeline_moe"] = pp_launches.get(rec["name"], 0)
        rec["launches_dp"] = coll_launches.get(rec["name"], 0)
    for rec in records[1:4]:
        rec["mesh_world1"] = {
            "tile_err": mesh_rec["world1"]["flash_tiles"].get(rec["name"]),
            "checked": mesh_rec["world1"]["flash_checked"].get(rec["name"]),
            "step_ms": mesh_rec["world1"]["step_ms"],
            "ratio_to_plain": mesh_rec["world1"]["ratio_to_plain"]}
        rec["profiler_trace_device_ms"] = sum(
            t for k, t in prof["flash_ms"].items()
            if rec["name"].replace("bwd_", "") in k)
    _wall_table()
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
