"""CTC in the port (``ops/ctc.py``: ``ctc_loss``, ``WarpCTC``,
``_contrib_CTCLoss`` and its alias ``ctc_loss``) against the JAX
package's, on the CPU.

Losses and their gradients (``jax.grad`` against ``torch.autograd``)
on numpy-seeded activations, with a sequence whose labels are all
padding (label length 0), repeated labels (the recursion may not skip
between them), and input lengths shorter than T.  ``WarpCTC`` in the
flat (T * N, C) layout and in (T, N, C), its backward ignoring the head
gradient on both sides.

Tolerance: fp32 ``1e-5`` relative and absolute on losses and
gradients (the same recursion over at most 12 frames, summed in
another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (registers the JAX ops)
from mxnet_tpu import ops as jops
from mxnet_tpu.ops import ctc as jctc

from mxnet_tpu_torch.ops import ctc as tctc
from mxnet_tpu_torch.ops import registry as treg
from test_torch_detection_ops import _run
from test_torch_op_set import _check, _n

TOL = 1e-5
T, N, C = 12, 4, 6
# row 0 full; row 1 repeats (2, 2) and (3, 3); row 2 all padding (label
# length 0); row 3 two labels
LABELS = np.array([[1, 2, 3, 4, 5],
                   [2, 2, 3, 3, 0],
                   [0, 0, 0, 0, 0],
                   [5, 1, 0, 0, 0]], np.float32)
INPUT_LENGTHS = np.array([12, 9, 12, 5], np.int32)


def _loss_and_grad(logits, labels, input_lengths=None):
    jl = jnp.asarray(labels.astype(np.int32))
    jil = None if input_lengths is None else jnp.asarray(input_lengths)

    def jsum(x):
        losses = jctc.ctc_loss(x, jl, input_lengths=jil)
        return jnp.sum(losses * jnp.arange(1, N + 1)), losses

    (_, jloss), jgrad = jax.jit(jax.value_and_grad(jsum, has_aux=True))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits.copy()).requires_grad_()
    tloss = tctc.ctc_loss(
        x, torch.from_numpy(labels).to(torch.int32),
        input_lengths=None if input_lengths is None
        else torch.from_numpy(input_lengths))
    tgrad, = torch.autograd.grad(
        (tloss * torch.arange(1, N + 1)).sum(), x)
    return [(np.asarray(jloss), tloss.detach().numpy()),
            (np.asarray(jgrad), tgrad.numpy())]


@pytest.mark.parametrize("lengths", ["full", "shorter"])
def test_ctc_loss_and_gradient_match_jax(lengths):
    logits = _n(1, T, N, C, scale=2.0)
    pairs = _loss_and_grad(logits, LABELS,
                           INPUT_LENGTHS if lengths == "shorter" else None)
    _check(pairs, TOL)
    (j, t), _ = pairs
    assert np.isfinite(t).all() and (t > 0).all()
    # the all-padding row is the probability of emitting only blanks
    lp = torch.log_softmax(torch.from_numpy(logits), -1)[:, 2, 0]
    np.testing.assert_allclose(t[2], -lp.sum().item(), rtol=TOL)


def test_ctc_loss_of_an_impossible_alignment_stays_finite():
    # 4 frames cannot emit (1, 1, 1), which needs 5 (a blank between
    # repeats): the loss is about -log(0) = 1e30 and no NaN
    logits = _n(2, 4, 1, 3)
    labels = np.array([[1, 1, 1]], np.float32)
    jl = jax.jit(jctc.ctc_loss)(jnp.asarray(logits),
                                jnp.asarray(labels, jnp.int32))
    tl = tctc.ctc_loss(torch.from_numpy(logits),
                       torch.from_numpy(labels).to(torch.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL)
    assert tl.item() > 1e29


CASES = {
    "warpctc_flat": ("WarpCTC",
                     lambda: [_n(3, T * N, C), LABELS],
                     {"label_length": 5, "input_length": T}, (0,)),
    "warpctc_flat_label_length": ("WarpCTC",
                                  lambda: [_n(4, T * N, C), LABELS],
                                  {"label_length": "3"}, (0,)),
    "warpctc_3d": ("WarpCTC", lambda: [_n(5, T, N, C), LABELS], {}, (0,)),
    "contrib_ctc_loss": ("_contrib_CTCLoss",
                         lambda: [_n(6, T, N, C), LABELS], {}, (0,)),
    "ctc_loss_alias": ("ctc_loss", lambda: [_n(7, T, N, C), LABELS[:, :3]],
                       {}, (0,)),
}
# the registry names these cases reach (read by test_torch_op_set.py)
PARITY_OPS = {op for op, *_ in CASES.values()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax_fp32(case):
    name, make, attrs, diff = CASES[case]
    _check(_run(name, make(), attrs, diff=diff), TOL)


def test_every_ctc_name_has_a_case():
    jnames = {n for n in jops.list_ops()
              if jops.get(n).fn.__module__ == "mxnet_tpu.ops.ctc"}
    assert PARITY_OPS == jnames == {"WarpCTC", "_contrib_CTCLoss",
                                    "ctc_loss"}


@pytest.mark.parametrize("layout", ["flat", "3d"])
def test_warpctc_backward_is_the_summed_loss_gradient(layout):
    """The head gradient is ignored: any cotangent gives d(sum of the
    CTC losses)/d(data), in both packages."""
    data = _n(8, T * N, C) if layout == "flat" else _n(8, T, N, C)
    x = torch.from_numpy(data.copy()).requires_grad_()
    out = treg.get("WarpCTC").fn(None, x, torch.from_numpy(LABELS),
                                 label_length=4)
    np.testing.assert_allclose(out.detach().numpy(),
                               torch.softmax(torch.from_numpy(data), -1),
                               rtol=TOL, atol=TOL)
    heads = (torch.zeros_like(out), torch.from_numpy(_n(9, *out.shape)))
    grads = [torch.autograd.grad(out, x, h, retain_graph=True)[0].numpy()
             for h in heads]
    np.testing.assert_array_equal(grads[0], grads[1])
    jlab = jnp.asarray(LABELS[:, :4], jnp.int32)
    jgrad = jax.jit(jax.grad(lambda z: jnp.sum(jctc.ctc_loss(
        z.reshape(T, N, C), jlab))))(jnp.asarray(data))
    np.testing.assert_allclose(grads[0], np.asarray(jgrad), rtol=TOL,
                               atol=TOL)
