#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

Drives the port's main path — the paged decode server — and holds its
hand-written CUDA kernel against the kernel's plain PyTorch version:

1. device: the card's name and power limit, torch/CUDA versions, and
   the build of every kernel from the sources in this checkout (nvcc);
2. kernel checks: ``ops/paged_attention.py``'s CUDA kernel against its
   plain version at the serving shapes, fp32 and bf16, with times of
   the kernel, the plain version, one PyTorch library call on the
   gathered table (``scaled_dot_product_attention``, a yardstick the
   port never calls) and the memory bound;
3. full-width serving over HTTP: the repo's largest LM config
   (``MFU_HEADLINE_CONFIG``: 8 layers, d_model 2048, vocab 32768) with
   seeded random bf16 weights, ``serve_decoder(num_slots=8, paged=True,
   kv_block=16)``, 16 concurrent greedy ``POST /generate`` requests;
4. teacher-forced parity: the paged backend with the kernel against the
   same backend pinned to the plain gather path, logits at every
   emission, fp32 and bf16.

Any failure raises and exits nonzero.  The second-to-last lines are the
``{"kernels": [...]}`` record and the ``nvidia-smi`` name/power line;
the last line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py                 # needs one card
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
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
    _build.load("paged_attention")
    log(f"[device] built paged_attention in {time.perf_counter() - t0:.2f} s"
        + ("" if "paged_attention" in _build.build_logs
           else " (an earlier build of this source was loaded)"))
    for line in _build.build_logs.get("paged_attention", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"[ptxas] {line.strip()}")
    return smi


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


def kernel_check(name, dtype, tol, B, H, M, block, dh, L, cursor, seed):
    """Kernel vs plain on every layer; times of kernel / plain / SDPA
    rotate over the layers so each call finds its pages cold in L2, as a
    decode tick does (all L layers of live pages exceed the 50 MB L2)."""
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
        ref = pa._gather_attention(q, pk, pv, bt, cur, layer, block)
        torch.cuda.synchronize()
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
    bound, bound_by = _bound_ms(cursor, B, H, M, block, dh, dtype)
    log(f"[kernel] {name}: max_abs_err={err:.3g} (atol=rtol={tol}) "
        f"kernel_us={t_k * 1e3:.2f} plain_us={t_p * 1e3:.2f} "
        f"library_us={t_l * 1e3:.2f} (sdpa err {lib_err:.3g}) "
        f"bound_us={bound * 1e3:.2f} ({bound_by})")
    return {"max_abs_err": err, "ms": t_k, "plain_ms": t_p,
            "library_ms": t_l, "bound_ms": bound, "bound_by": bound_by}


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
        tick_profile(dec)
        return launches
    finally:
        server.shutdown()
        server.server_close()
        sched.close()


def tick_profile(dec, steps=10):
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
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t:
            rows.append((t / steps / 1e3, ev.key))
    rows.sort(reverse=True)
    busy = sum(t for t, _ in rows)
    log(f"[tick] 8 slots at ~500 tokens: {wall_ms:.3f} ms/tick wall, "
        f"device busy {busy:.3f} ms, idle share "
        f"{1 - busy / wall_ms:.3f}; top device time per tick: "
        + "; ".join(f"{name[:48]} {t:.3f} ms" for t, name in rows[:6]))


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
    tok = np.zeros(3, np.int64)
    tok[0] = pick(outs[-1])
    fed.append(int(tok[0]))
    occ = np.array([True, False, False])
    for _ in range(4):
        lg, _ = pg.step(tok, occ)
        outs.append(host(lg)[:1])
        tok[0] = pick(outs[-1][0])
        fed.append(int(tok[0]))
    outs.append(host(pg.admit(1, fb)))
    tok[1] = pick(outs[-1])
    fed.append(int(tok[1]))
    occ = np.array([True, True, False])
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


# -------------------------------------------------------------------- main
def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = phase_device()
    kern = phase_kernels()
    cfg, params = _params(seed=0)
    launches = phase_serve(cfg, params)
    phase_parity(cfg, params)
    k = kern["bf16"]       # the serving path runs the kernel in bf16
    record = {
        "name": "paged_attention", "route": "cuda", "source": PAGED_SRC,
        "replaces": PAGED_REPLACES, "launches": launches,
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        "us": k["ms"] * 1e3, "plain_us": k["plain_ms"] * 1e3,
        "library_us": k["library_ms"] * 1e3,
        "bound_us": k["bound_ms"] * 1e3,
        "fp32": kern["fp32"],
    }
    print(json.dumps({"kernels": [record]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
