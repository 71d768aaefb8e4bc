"""The port's declared invariants (parity: ``mxnet_tpu/analysis/config.py``).

The single place where the port names its steady-state entry points,
its sanctioned sync boundaries, and the primitive sets each rule family
matches on, in torch's terms.  A new loop or a new background thread
grows THIS file; the lint then proves the new surface obeys the same
invariants.
"""

_P = "mxnet_tpu_torch."

# --------------------------------------------------------------- host-sync
# Steady-state entry points: code reachable from these must never wait
# for the card.  These are the per-batch/per-tick loops whose syncs the
# CPU tests count and chip_smoke.py samples under
# torch.cuda.set_sync_debug_mode.
ENTRY_POINTS = tuple(_P + e for e in (
    # the fit loops: Module.fit, FusedTrainer.fit and the two steps
    "module.base_module.BaseModule._fit_epochs",
    "trainer.FusedTrainer.step",
    "trainer.FusedTrainer.step_multi",
    "trainer.FusedTrainer._fit_epochs",
    # the serving tick (one sanctioned sync: the sampled tokens)
    "serving.scheduler.SlotScheduler._tick",
    # the bucketed kvstore update
    "kvstore_fused.FusedUpdateEngine.handle_push",
    "kvstore_fused.FusedUpdateEngine.handle_pull",
    # the survival checkpoint's capture
    "checkpoint.snapshot",
    "checkpoint.CheckpointManager.save",
    # elastic membership poll, every batch inside the fit loops; the
    # heartbeat carries the flight ring's step timings: host only
    "parallel.coordinator.CoordinatorClient.step_poll",
    "parallel.coordinator.CoordinatorClient._heartbeat_loop",
    # the fleet plane's sweep and the router: HTTP and ring reads
    "telemetry.fleet.FleetScraper.scrape_once",
    "serving.router.ReplicaRouter.scrape_once",
    "serving.router.ReplicaRouter.route_generate",
    # the paged-KV allocator's tick: host-side bookkeeping
    "serving.paged_kv.PagedSlots.step",
    # the span flush behind GET /spans.json, the perf plane's scrapes
    "telemetry.tracing.spans_payload",
    "telemetry.perf.publish_gauges",
    "telemetry.perf.profile_payload",
    # the port's own loops: the parameter-server stores' push and pull
    # (the card's values leave through a pinned copy on a side stream;
    # the loop waits once per key in wait_pulls), and the host engine
    "kvstore.KVStoreDist.push",
    "kvstore.KVStoreDist.pull",
    "engine.push",
    # the collective dist_sync's bucket step (one all-reduce a bucket),
    # the sharded update (reduce-scatter, the rule on the slice, all-gather)
    # and the metric window's drain over a mesh
    "kvstore_fused.FusedUpdateEngine._step_bucket",
    "kvstore_fused.FusedUpdateEngine._step_sharded",
    # the pipeline's 1F1B step (the closure make_pipeline_train_step
    # returns), GPipe's autograd node, the MoE layer, and the one
    # collective under the pipeline and the ring
    "parallel.pipeline.make_pipeline_train_step.<locals>.step",
    "parallel.pipeline._GPipe.forward",
    "parallel.pipeline._GPipe.backward",
    "parallel.moe.moe_ffn",
    "parallel.dist.exchange",
))

# Sanctioned sync boundaries: the analyzer does not descend into these.
# qualname -> why waiting behind it is the design, not a leak.  The call
# site itself stays on the hot path; only the callee's interior is
# excused.
BOUNDARIES = {_P + k: v for k, v in {
    "engine.AsyncWindow.drain":
        "the explicit epoch/checkpoint-boundary drain: THE sanctioned "
        "wait of the bounded-window design",
    "engine.AsyncWindow._wait_one":
        "window-full backpressure: waiting on the oldest step's event "
        "once MXTPU_ASYNC_DEPTH steps are in flight is the contract",
    "telemetry.health.sentinel_check":
        "the sentinel's reporting boundary: reads its parked flags only "
        "at the window's drain and overflow sites",
    "checkpoint.save.<locals>._write":
        "the checkpoint writer: on its own thread (background=True), or "
        "a foreground save the caller asked to wait for; the capture "
        "(checkpoint.snapshot) only clones on the card",
    "monitor.Monitor.toc_print":
        "the opt-in debugging Monitor: its interval-gated rows read the "
        "card by contract (no production loop installs one)",
    "autotune.search.measure":
        "the autotuner's candidate timer: warm-up and best-of-k over CUDA "
        "events at bind- or admit-time search sites, never from a tick",
    "serving.scheduler._host":
        "the tick's one sanctioned sync: the sampled tokens of the step "
        "come to the host once a tick, to stream and retire requests",
    "ops.custom._CustomFn.forward":
        "Custom's user code runs on host arrays: 2 syncs a batch (its "
        "forward's download; the backward's), counted by "
        "ops.custom.stats()",
    "ops.custom._CustomFn.backward":
        "Custom's user backward on host arrays: the second of its 2 "
        "syncs a batch",
    "kvstore.KVStoreDist.wait_pulls":
        "the PS stores' one wait per key a step on the loop's thread "
        "(KVStoreDist.comm_stats()['loop_waits'])",
    # the collectives: NCCL queues them on the stream; gloo on CUDA
    # tensors stages them through the host and its call returns after
    # the card produced the input (PERF.md section 7)
    "parallel.dist.all_reduce_stats":
        "a collective of the collective dist_sync, the metric window's "
        "drain and the mesh sentinel: every rank meets in it",
    "parallel.dist.reduce_scatter":
        "the sharded update's gradient collective: every rank meets in it",
    "parallel.dist.all_gather":
        "the sharded update's parameter collective: every rank meets in it",
}.items()}

# Device-to-host sync primitives, matched as method names on any
# receiver (torch.cuda.synchronize, Stream/Event.synchronize, a tensor's
# .item() ...).  The ones a tensor's size depends on its data
# (nonzero, masked_select, unique) or whose answer is a host bool
# (equal) wait for the card like .item() does.
SYNC_METHODS = frozenset({
    "item", "tolist", "cpu", "numpy", "asnumpy", "wait_to_read",
    "synchronize", "nonzero", "masked_select", "unique", "equal",
})
# ... and repeat_interleave, unless output_size= tells it the size.
SIZED_SYNC_METHODS = {"repeat_interleave": "output_size"}
# ... and .to() a host device (t.to("cpu"), t.to(device="cpu")), which
# is .cpu() by another name.
HOST_COPY_METHODS = frozenset({"to"})
HOST_DEVICES = frozenset({"cpu"})
# ... and an upload from pageable host memory, which waits for the
# stream (the card flags it): .to(<device>)/.cuda() of a host tensor
# made in the function (torch.from_numpy/tensor/as_tensor with no
# device) without non_blocking=True, and torch.tensor/as_tensor(...,
# device=<a device other than the host>).  A pinned copy uploaded with
# non_blocking=True does not wait.
HOST_TENSOR_CALLS = frozenset({"from_numpy", "tensor", "as_tensor"})
UPLOAD_METHODS = frozenset({"to", "cuda"})
# ... and as resolved dotted calls (module functions).
SYNC_CALLS = frozenset({"torch.cuda.synchronize"})
# numpy module aliases whose asarray/array on a tensor-typed argument is
# a hidden host sync (Tensor.__array__ -> .cpu()).
NUMPY_MODULES = frozenset({"numpy"})
NUMPY_SYNC_FUNCS = frozenset({"asarray", "array", "ascontiguousarray"})
# builtins that call Tensor.__float__/__int__/__bool__ (NDArray's too).
BUILTIN_CASTS = frozenset({"float", "int", "bool"})
# tensor-ish class names for the cheap local type inference: isinstance
# narrowing, constructors, parameter annotations
TENSOR_CLASSES = frozenset({"Tensor", "NDArray", "RowSparseNDArray"})
# torch factory functions whose result is a tensor (on the card or not:
# the walk cannot tell, and over-approximates)
TENSOR_FACTORIES = frozenset({
    "tensor", "as_tensor", "zeros", "ones", "empty", "full", "arange",
    "rand", "randn", "randint", "zeros_like", "ones_like", "empty_like",
    "full_like", "stack", "cat", "where",
})

# ------------------------------------------------------- capture purity
# Code that runs while torch.cuda.graph captures runs ONCE; a replay
# repeats only the kernels.  Roots: the bodies entered inside
# `with torch.cuda.graph(...)`, the registered op bodies (step_multi
# replays them), every function of these modules, and the forward/
# backward of the autograd Functions those reach.
CAPTURE_CONTEXTS = frozenset({"torch.cuda.graph", "cuda.graph"})
TRACED_MODULES = (_P + "optim_rules",)
# Decorators that mark a function as an op implementation.
OP_REGISTER_DECORATORS = frozenset({
    "register()", "registry.register()", "ops.register()",
    "_register_op()",
})
# Module prefixes that must not be called from captured code.
TRACE_BANNED_MODULE_PREFIXES = (
    ("time", "host clock read under capture: one value, stale in every "
             "replay"),
    ("numpy.random", "host RNG under capture: one draw, replayed forever "
                     "(draw from the op's generator)"),
    ("random", "host RNG under capture: one draw, replayed forever "
               "(draw from the op's generator)"),
    (_P + "telemetry", "telemetry under capture records once and "
                       "vanishes from replays — record at the replay "
                       "site"),
)
# Capture-time helpers the walk does not enter (qualname -> why they
# may do host work under capture).  The telemetry package is never
# entered either: a call into it is flagged (or annotated) where it is
# made.
CAPTURE_BOUNDARIES = {_P + k: v for k, v in {
    "ops.custom._custom":
        "Custom runs the user's numpy on the host: step_multi refuses a "
        "graph holding it (FusedTrainer.step_multi), so it is never "
        "captured",
    "ops._build.load":
        "the kernel library loader: builds and caches a library on first "
        "use; every capture site loads its libraries first (the "
        "trainer's eager warm-up steps, make_bench_fn's launch() before "
        "torch.cuda.graph), so under capture it is a dict read",
}.items()}
# Telemetry instrument method names (module-global Counter/Gauge/
# Histogram objects created from the telemetry registry).
TELEMETRY_INSTRUMENT_METHODS = frozenset({"inc", "observe", "set", "dec"})
# Parameter names that are not tensors in op-impl signatures.
UNTRACED_PARAM_NAMES = frozenset({
    "self", "cls", "ctx", "attrs", "key", "is_train", "platform",
    "name", "generator", "gen", "device", "dtype", "schedule", "impl",
})

# ------------------------------------------------------------------- locks
# Thread-entry markers: functions handed to these run on another thread.
THREAD_TARGET_CALLS = frozenset({
    "Thread", "threading.Thread", "Timer", "threading.Timer",
})
THREAD_REGISTER_CALLS = frozenset({
    "signal.signal", "atexit.register", "weakref.finalize",
})
# Method names that are thread entries by framework contract.
THREAD_ENTRY_METHOD_NAMES = frozenset({
    "do_GET", "do_POST", "do_PUT", "do_DELETE", "handle", "handle_error",
    "service_actions", "run",
})
# Host-engine pushes: the task (a function or a lambda's calls) runs on
# an engine worker thread (the native engine's pool).
ENGINE_PUSH_TARGETS = frozenset({
    _P + "_native.NativeEngine.push", _P + "engine.push",
})
# Lock-ish constructors (Condition aliases the lock it wraps).
LOCK_CONSTRUCTORS = frozenset({
    "Lock", "RLock", "Condition", "threading.Lock", "threading.RLock",
    "threading.Condition",
})

# --------------------------------------------------------------- env-docs
# One direction: every knob the port reads is documented.  The doc is
# the reference's (docs/how_to/env_var.md, unchanged), so a documented
# knob the port does not read is no finding.
ENV_VAR_PATTERN = r"\b((?:MXTPU|BENCH)_[A-Z0-9_]+)\b"
ENV_DOC = "docs/how_to/env_var.md"
ENV_PACKAGE = "mxnet_tpu_torch"
