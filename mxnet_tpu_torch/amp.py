"""Mixed precision policy of the port: ``amp_dtype()`` of
``mxnet_tpu/amp.py`` (the loss scaler and the fp32 masters of the
Module path wait for ROADMAP Queue 1 item 7)."""
from __future__ import annotations

import os

import torch

from .base import MXNetError

__all__ = ["amp_dtype"]


def amp_dtype():
    """``torch.bfloat16`` when ``MXTPU_AMP`` asks for bf16, None when it
    is unset or off; an unknown value raises rather than quietly
    training in full precision."""
    raw = os.environ.get("MXTPU_AMP", "").strip().lower()
    if raw in ("", "0", "off", "false", "no", "none"):
        return None
    if raw in ("bf16", "bfloat16", "1", "on", "true", "yes"):
        return torch.bfloat16
    raise MXNetError(f"MXTPU_AMP={raw!r}: unknown AMP policy (supported: "
                     "'bf16', '0'/'off')")
