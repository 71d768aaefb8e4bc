#!/usr/bin/env python3
"""Two trees of the PyTorch port, in turns, on one card: the LM training
step and the decode tick.

    python3 tools/torch_ab.py OTHER_ROOT [THIS_ROOT]

Runs OTHER, THIS, THIS, OTHER, each in a fresh process whose
``mxnet_tpu_torch`` comes from that tree (which builds its own kernels
into its own ``build/torch_kernels/``), while the measurement code is
this checkout's ``chip_smoke.py`` for every run:

- ``tick_profile``: a decode tick of ``MFU_HEADLINE_CONFIG`` (bf16, 8
  slots at ~500 cached tokens): wall, device busy, idle share, and the
  paged-attention kernels' device ms;
- ``phase_train``: the training step at full width (batch 8 x 1024, bf16,
  Adam): the kernel-vs-``impl="lax"`` parity step, 6 timed steps, and a
  profile: step wall, device busy, idle share, device ms per flash
  kernel.

Each run prints ``[ab] {json}``; the last lines are a table.  Compare
trees only within one call: the card and its host change between calls.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _one(root):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import mxnet_tpu_torch
    from mxnet_tpu_torch.models.decode import KVDecoder

    if not torch.cuda.is_available():
        raise SystemExit("torch_ab: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(f"[ab] tree {root}: package {mxnet_tpu_torch.__file__}")
    cfg, params = cs._params(seed=0)
    dec = KVDecoder(params, num_layers=cfg["num_layers"],
                    num_heads=cfg["num_heads"], max_len=cs.MAX_LEN,
                    dtype=torch.bfloat16)
    tick = cs.tick_profile(dec)
    del dec, params
    torch.cuda.empty_cache()
    _launches, train = cs.phase_train()
    out = {"root": root, "tick": tick,
           "train": {"step_ms": train["step_ms"], "busy_ms": train["busy_ms"],
                     "idle_share": 1 - train["busy_ms"] / train["step_ms"],
                     "tokens_per_s": train["tokens_per_s"],
                     "flash_ms": train["flash_ms"]}}
    print("[ab] " + json.dumps(out), flush=True)


def main(argv):
    if len(argv) >= 2 and argv[0] == "--one":
        _one(argv[1])
        return 0
    if not 1 <= len(argv) <= 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = argv[0]
    this = argv[1] if len(argv) == 2 else HERE
    runs = []
    for root in (other, this, this, other):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], capture_output=True,
                              text=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            return proc.returncode
        runs.append(next(json.loads(line[len("[ab] "):])
                         for line in proc.stdout.splitlines()
                         if line.startswith("[ab] {")))
    print("[ab] tree | tick wall ms, busy ms, idle, paged ms | step ms, "
          "busy ms, idle, tokens/s, dQ ms")
    for r in runs:
        t, s = r["tick"], r["train"]
        print(f"[ab] {r['root']} | {t['wall_ms']:.3f}, {t['busy_ms']:.3f}, "
              f"{t['idle_share']:.3f}, {t['paged_ms']:.3f} | "
              f"{s['step_ms']:.2f}, {s['busy_ms']:.2f}, "
              f"{s['idle_share']:.4f}, {s['tokens_per_s']:.1f}, "
              f"{s['flash_ms']['flash_bwd_dq']:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
