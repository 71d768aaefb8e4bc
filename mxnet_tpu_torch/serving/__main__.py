"""Decode-serving process of the port: one replica, or a routed fleet.

The port's counterpart of the JAX package's ``tools/serve.py``, run as a
module::

    # serve a save_checkpoint()-style transformer_lm checkpoint
    python -m mxnet_tpu_torch.serving --prefix ckpt/lm --epoch 10 \\
        --num-layers 4 --num-heads 8 --max-len 512 --port 9200

    # a randomly initialised tiny LM (no checkpoint needed)
    python -m mxnet_tpu_torch.serving --demo --port 9200

    # int8 weights, paged KV cache (16-token pages), bf16 compute
    python -m mxnet_tpu_torch.serving --demo --int8 --kv-block 16 \\
        --dtype bfloat16

    # a routed 2-replica local fleet (router + 2 replica subprocesses)
    python -m mxnet_tpu_torch.serving --router --fleet 2 --demo --port 9100

    # a router over running replicas
    python -m mxnet_tpu_torch.serving --router --replicas h1:9200,h2:9200

    curl -s localhost:9200/generate -d '{"prompt": [1, 2, 3], "max_tokens": 16}'

Replicas run on the card (``--device cuda``, the default) unless
``--device cpu`` is given.  SIGTERM drains gracefully: the scheduler
stops admitting, queued and in-flight requests finish, then the process
exits 0.  ``--trace`` (or ``MXTPU_TRACE=1``) records request spans:
every process serves its span buffer at ``GET /spans.json`` and the
router serves burn rates at ``GET /slo``.  ``--coord``/``--register``
(coordinator discovery) wait for ``parallel/coordinator.py`` (ROADMAP
Queue 1 item 10) and refuse.

Knobs (flags override env): MXTPU_SERVE_SLOTS, MXTPU_SERVE_QUEUE,
MXTPU_SERVE_DEADLINE_MS, MXTPU_PREDICT_INT8, MXTPU_KV_BLOCK,
MXTPU_PREFIX_CACHE, MXTPU_SERVE_REPLICAS, MXTPU_ROUTER_SCRAPE_S,
MXTPU_ROUTER_RETRIES, MXTPU_TRACE, MXTPU_TRACE_SAMPLE,
MXTPU_SLO_TTFT_MS, MXTPU_SLO_AVAIL.
"""
from __future__ import annotations

import argparse
import os
import re
import signal
import subprocess
import sys
import threading
import time

COORD_REFUSAL = ("--coord/--register need parallel/coordinator.py, which "
                 "is not ported yet (ROADMAP Queue 1 item 10); list the "
                 "replicas with --replicas or MXTPU_SERVE_REPLICAS")


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.serving",
        description="continuous-batching decode server / fleet router")
    ap.add_argument("--prefix", help="checkpoint prefix (save_checkpoint)")
    ap.add_argument("--epoch", type=int, default=0)
    ap.add_argument("--demo", action="store_true",
                    help="serve a randomly initialised tiny LM")
    ap.add_argument("--num-layers", type=int, default=2)
    ap.add_argument("--num-heads", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=64,
                    help="demo model width (checkpoints carry their own)")
    ap.add_argument("--vocab-size", type=int, default=256,
                    help="demo vocab (checkpoints carry their own)")
    ap.add_argument("--max-len", type=int, default=128,
                    help="KV-cache length = prompt + generation budget")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda",
                    help="where the replica runs: cuda (default) or cpu")
    ap.add_argument("--int8", action="store_true",
                    help="int8 weights (or MXTPU_PREDICT_INT8=1)")
    ap.add_argument("--slots", type=int, default=None,
                    help="decode slots (MXTPU_SERVE_SLOTS, default 4)")
    ap.add_argument("--queue", type=int, default=None,
                    help="admission queue bound (MXTPU_SERVE_QUEUE, 16)")
    ap.add_argument("--deadline-ms", type=int, default=None,
                    help="default per-request deadline "
                         "(MXTPU_SERVE_DEADLINE_MS, 30000)")
    ap.add_argument("--kv-block", type=int, default=None,
                    help="paged KV cache page size in tokens "
                         "(MXTPU_KV_BLOCK; 0/unset = contiguous)")
    ap.add_argument("--register", action="store_true",
                    help="self-register with a coordinator (refused)")
    ap.add_argument("--router", action="store_true",
                    help="run the fleet router instead of a replica")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="with --router: spawn N local replica "
                         "subprocesses (same model flags) and route "
                         "over them")
    ap.add_argument("--replicas", default=None,
                    help="with --router: static host:port list "
                         "(MXTPU_SERVE_REPLICAS)")
    ap.add_argument("--coord", default=None,
                    help="coordinator host:port (refused)")
    ap.add_argument("--scrape-s", type=float, default=None,
                    help="router healthz scrape interval "
                         "(MXTPU_ROUTER_SCRAPE_S, 1s)")
    ap.add_argument("--retries", type=int, default=None,
                    help="router idempotent re-routes per request "
                         "(MXTPU_ROUTER_RETRIES, 2)")
    ap.add_argument("--trace", action="store_true",
                    help="record request spans (MXTPU_TRACE=1)")
    ap.add_argument("--port", type=int, default=9200)
    ap.add_argument("--addr", default="127.0.0.1")
    return ap.parse_args(argv)


def demo_params(num_layers, num_heads, d_model, vocab_size, max_len):
    """The demo LM's params: ``transformer_lm``'s arguments in bind
    order, each drawn from ``N(0, 0.08)`` by one
    ``np.random.RandomState(0)`` — the JAX package's demo weights."""
    import numpy as np

    from ..models.transformer import transformer_lm

    net = transformer_lm(num_layers=num_layers, num_heads=num_heads,
                         d_model=d_model, seq_len=max_len,
                         vocab_size=vocab_size)
    shapes, _, _ = net.infer_shape(data=(1, max_len),
                                   softmax_label=(1, max_len))
    rs = np.random.RandomState(0)
    return {name: rs.normal(0, 0.08, shape).astype(np.float32)
            for name, shape in zip(net.list_arguments(), shapes)
            if name not in ("data", "softmax_label")}


def build_decoder(args):
    """KVDecoder from a checkpoint (or the demo params) on ``--device``."""
    from ..models.decode import KVDecoder

    quantize = "int8" if (args.int8 or os.environ.get(
        "MXTPU_PREDICT_INT8", "0").lower() not in ("", "0", "false")) \
        else None
    if args.demo:
        params = demo_params(args.num_layers, args.num_heads, args.d_model,
                             args.vocab_size, args.max_len)
    else:
        if not args.prefix:
            raise SystemExit("need --prefix (or --demo)")
        from ..model import load_checkpoint

        _, params, _ = load_checkpoint(args.prefix, args.epoch, ctx="cpu")
    return KVDecoder(params, num_layers=args.num_layers,
                     num_heads=args.num_heads, max_len=args.max_len,
                     dtype=args.dtype, quantize=quantize,
                     device=args.device)


def _arm_sigterm():
    """SIGTERM/SIGINT -> a stop event the main loop polls, so ``kill``
    triggers the graceful drain instead of an abrupt death."""
    stop = threading.Event()

    def _handler(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _handler)
    try:
        signal.signal(signal.SIGINT, _handler)
    except ValueError:
        pass
    return stop


def _main_replica(args):
    from .. import telemetry
    from .server import serve_decoder

    telemetry.enable()  # a server without metrics is not operable
    if args.trace:
        telemetry.tracing.enable_tracing()
    stop = _arm_sigterm()
    decoder = build_decoder(args)
    server, scheduler = serve_decoder(
        decoder, port=args.port, addr=args.addr, num_slots=args.slots,
        queue_size=args.queue, default_deadline_ms=args.deadline_ms,
        kv_block=args.kv_block)
    host, port = server.server_address[:2]
    paged = scheduler.paged_stats()
    print(f"serving on http://{host}:{port}  "
          f"(slots={scheduler.num_slots} queue={scheduler.queue_size} "
          f"deadline_ms={scheduler.default_deadline_ms} "
          f"int8={decoder.quantize == 'int8'} "
          f"paged={paged['block'] if paged else 0} "
          f"device={decoder.device})", flush=True)
    try:
        while not stop.wait(0.5):
            pass
        print("SIGTERM: draining (in-flight requests finishing)",
              flush=True)
        scheduler.drain()
        while not scheduler.drained:
            time.sleep(0.05)
        print("drained, exiting", flush=True)
    finally:
        server.shutdown()
        scheduler.close()
    return 0


def _replica_flags(args):
    flags = [sys.executable, "-m", "mxnet_tpu_torch.serving"]
    if args.demo:
        flags.append("--demo")
    else:
        flags += ["--prefix", args.prefix or "", "--epoch",
                  str(args.epoch)]
    flags += ["--num-layers", str(args.num_layers),
              "--num-heads", str(args.num_heads),
              "--d-model", str(args.d_model),
              "--vocab-size", str(args.vocab_size),
              "--max-len", str(args.max_len),
              "--dtype", args.dtype, "--device", args.device,
              "--port", "0", "--addr", args.addr]
    for flag, value in (("--slots", args.slots), ("--queue", args.queue),
                        ("--deadline-ms", args.deadline_ms),
                        ("--kv-block", args.kv_block)):
        if value is not None:
            flags += [flag, str(value)]
    if args.int8:
        flags.append("--int8")
    if args.trace:
        flags.append("--trace")   # one flag traces the whole fleet
    return flags


def _spawn_fleet(args):
    """Spawn ``--fleet N`` replica subprocesses (same model flags,
    ephemeral ports) and read their addresses from the 'serving on'
    line.  Children are stopped with us (SIGTERM -> graceful drain)."""
    flags = _replica_flags(args)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (here, env.get("PYTHONPATH")) if p)
    procs, addrs = [], []
    for _ in range(args.fleet):
        procs.append(subprocess.Popen(
            flags, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env))
    try:
        for p in procs:
            addr, deadline = None, time.time() + 300
            while time.time() < deadline:
                line = p.stdout.readline()
                if not line:
                    break
                sys.stdout.write("[replica %d] %s" % (p.pid, line))
                m = re.search(r"serving on http://([0-9.]+:[0-9]+)", line)
                if m:
                    addr = m.group(1)
                    break
            if addr is None:
                raise SystemExit(
                    f"replica pid {p.pid} never reported its address")
            addrs.append(addr)
            # keep the pipe drained so the child never blocks on stdout
            threading.Thread(target=lambda f=p.stdout: [None for _ in f],
                             daemon=True).start()
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    return procs, addrs


def _main_router(args):
    from .. import telemetry
    from .router import ReplicaRouter, start_router

    telemetry.enable()
    if args.trace:
        telemetry.tracing.enable_tracing()
    stop = _arm_sigterm()
    procs = []
    replicas = [a.strip() for a in (args.replicas or "").split(",")
                if a.strip()] or None
    if args.fleet:
        procs, spawned = _spawn_fleet(args)
        replicas = (replicas or []) + spawned
    try:
        router = ReplicaRouter(replicas=replicas, scrape_s=args.scrape_s,
                               retries=args.retries)
        server = start_router(router, port=args.port, addr=args.addr)
        host, port = server.server_address[:2]
        print(f"routing on http://{host}:{port} over "
              f"{len(router.replicas())} replica(s) (scrape every "
              f"{router.scrape_s}s, retries {router.retries}"
              f"{', tracing on' if args.trace else ''}) — GET /slo for "
              "burn rates, /spans.json for the span buffer", flush=True)
        try:
            while not stop.wait(0.5):
                pass
            print("SIGTERM: stopping router"
                  + (" and draining local fleet" if procs else ""),
                  flush=True)
        finally:
            server.shutdown()
            router.stop()
    finally:
        for p in procs:
            p.terminate()       # SIGTERM -> each replica drains
        for p in procs:
            try:
                p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return 0


def main(argv=None):
    args = _parse_args(argv)
    if args.coord or args.register:
        raise SystemExit(COORD_REFUSAL)
    if args.router:
        return _main_router(args)
    return _main_replica(args)


if __name__ == "__main__":
    sys.exit(main())
