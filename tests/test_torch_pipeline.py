"""The port's pipeline parallelism against the JAX package's, on the CPU.

One port counterpart for each pipeline case of
``tests/test_pipeline_moe.py`` (GPipe through ``pipeline_apply`` and
``pipeline_apply_tree``, the 1F1B ``make_pipeline_train_step`` on a
``pipe`` mesh of 4 and on (data 2, pipe 2), the shape-changing funnel,
the transformer LM trunk with and without remat, the LSTM example, the
``train_pp.py`` loop), plus ``ppermute``, the refusals and the carry of
JAX trees into the port's.  The port's side runs in one gloo world of 4
processes (``tests/torch_mesh_worlds.py``); the JAX side is the
reference's own functions on 4 of the virtual CPU devices, from the
same numpy-seeded inputs and weights.  Tolerances are the reference
test's own: losses rtol 1e-5, gradients rtol 2e-4 / atol 1e-5, outputs
rtol 1e-5 / atol 1e-5 (2e-4 for the transformer's logits).
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mxnet_tpu.ops.loss import token_nll as jnll
from mxnet_tpu.parallel import pipeline as jpp
from mxnet_tpu.parallel.mesh import create_mesh as jcreate_mesh
from mxnet_tpu.parallel.mesh import shard_map

import test_pipeline_moe as ref
import torch_mesh_worlds as worlds
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel import pipeline as tpp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 4
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)


def _jmesh(shape, axes):
    n = int(np.prod(shape))
    return jcreate_mesh(shape, axes, devices=jax.devices("cpu")[:n])


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _jpaths(tree):
    from jax.tree_util import keystr, tree_flatten_with_path

    return {keystr(p): np.asarray(v) for p, v in
            tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------ JAX side
def _jax_ppermute():
    rs = np.random.RandomState(7)
    x = rs.normal(size=(S, 3, 2)).astype(np.float32)
    w = rs.normal(size=(S, 3, 2)).astype(np.float32)
    mesh = _jmesh((S,), ("pipe",))
    out = {}
    for name, perm in (("cyclic", [(i, (i + 1) % S) for i in range(S)]),
                       ("partial", [(0, 2), (1, 0)])):
        def f(xs, perm=perm):
            return shard_map(
                lambda a: jax.lax.ppermute(a, "pipe", perm), mesh=mesh,
                in_specs=P("pipe"), out_specs=P("pipe"))(xs)

        y = f(jnp.asarray(x.reshape(S * 3, 2)))
        g = jax.grad(lambda a: jnp.sum(f(a) * w.reshape(S * 3, 2)))(
            jnp.asarray(x.reshape(S * 3, 2)))
        out[name] = dict(perm=perm, x=x, w=w,
                         y=np.asarray(y).reshape(S, 3, 2),
                         grad=np.asarray(g).reshape(S, 3, 2))
    return out


def _jax_apply():
    rs = np.random.RandomState(0)
    width, n_micro, mb = 8, 4, 2
    mesh = _jmesh((S,), ("pipe",))
    per_stage = ref._make_stage_params(rs, width, S)
    stacked = jpp.stack_stage_params(per_stage)
    x = rs.normal(size=(n_micro * mb, width)).astype(np.float32)
    outs = jpp.pipeline_apply(ref._stage_fn, jpp.shard_stacked(mesh, stacked),
                              jpp.microbatch(jnp.asarray(x), n_micro), mesh)
    return dict(stacked=_np_tree(stacked), x=x, n_micro=n_micro,
                out=np.asarray(outs))


def _jax_apply_grads():
    rs = np.random.RandomState(1)
    width, n_micro, mb = 6, 4, 2
    mesh = _jmesh((S,), ("pipe",))
    stacked = jpp.stack_stage_params(ref._make_stage_params(rs, width, S))
    x = rs.normal(size=(n_micro * mb, width)).astype(np.float32)
    y = rs.normal(size=(n_micro * mb, width)).astype(np.float32)

    def pipe_loss(params):
        out = jpp.pipeline_apply(ref._stage_fn, params,
                                 jpp.microbatch(jnp.asarray(x), n_micro),
                                 mesh)
        return jnp.mean((out.reshape(-1, width) - y) ** 2)

    loss, grads = jax.jit(jax.value_and_grad(pipe_loss))(
        jpp.shard_stacked(mesh, stacked))
    return dict(stacked=_np_tree(stacked), x=x, y=y, n_micro=n_micro,
                loss=float(loss), grads=_np_tree(grads))


def _jax_tlm(remat, steps):
    """``ref._pipelined_lm`` with its token ids kept: the same draws."""
    D, T, vocab, n_micro, mb = 16, 8, 32, 4, 2
    rs = np.random.RandomState(0)
    mesh = _jmesh((S,), ("pipe",))
    blocks = [ref._tblock_params(rs, D) for _ in range(S)]
    stacked = {k: jnp.stack([b[k][None] for b in blocks]) for k in blocks[0]}
    embed = jnp.asarray(rs.normal(0, 0.1, (vocab, D)).astype(np.float32))
    head = jnp.asarray(rs.normal(0, 0.1, (D, vocab)).astype(np.float32))
    X = rs.randint(0, vocab, (n_micro * mb, T))
    Y = np.roll(X, -1, axis=1).astype(np.int32)
    X = X.astype(np.int32)
    stage_fn = jpp.stacked_blocks_stage(ref._tblock)

    def pipe_loss(params):
        h = params["embed"][X]
        out = jpp.pipeline_apply(stage_fn, params["trunk"],
                                 jpp.microbatch(h, n_micro), mesh,
                                 remat=remat)
        lp = jax.nn.log_softmax(out.reshape(-1, T, D) @ params["head"], -1)
        return -jnp.take_along_axis(lp, Y[..., None], axis=-1).mean()

    params = {"embed": embed, "head": head, "trunk": stacked}
    case = dict(params=_np_tree(params), X=X, Y=Y, n_micro=n_micro,
                remat=remat, steps=steps)
    params["trunk"] = jpp.shard_stacked(mesh, stacked)
    step = jax.jit(jax.value_and_grad(pipe_loss))
    if not steps:
        loss, grads = step(params)
        return case, dict(loss=float(loss), grads=_jpaths(grads))
    losses = []
    for _ in range(steps):
        loss, grads = step(params)
        losses.append(float(loss))
        params = jax.tree_util.tree_map(lambda w, d: w - 0.2 * d, params,
                                        grads)
    return case, dict(losses=losses)


def _jax_lstm():
    ex = _load("examples/model-parallel-lstm/lstm_pipeline.py",
               "_lstm_pipeline_example")
    layers, H, T, vocab, n_micro, mb = 4, 32, 16, 64, 4, 4
    mesh = _jmesh((layers,), ("pipe",))
    rs = np.random.RandomState(42)
    X = rs.randint(0, vocab, (n_micro * mb, T))
    Y = (X * 3 + 1) % vocab
    params = ex.build(layers, H, vocab, mesh)
    pipe_loss, seq_loss = ex.make_losses(mesh, n_micro, jnp.asarray(X),
                                         jnp.asarray(Y), vocab)
    out = {}
    for name, fn in (("pipe", pipe_loss), ("seq", seq_loss)):
        loss, grads = jax.jit(jax.value_and_grad(fn))(params)
        out[name] = dict(loss=float(loss), grads=_jpaths(grads))
    return dict(params=_np_tree(params), X=X, Y=Y, n_micro=n_micro,
                vocab=vocab), out


def _jax_1f1b(seed, S_, M, mb, mesh_shape, axes, data=None):
    D, T, vocab = 16, 8, 32
    rs = np.random.RandomState(seed)
    mesh = _jmesh(mesh_shape, axes)
    fns, trees = ref._lm_stages(rs, S_, D, vocab)
    stacked, meta = jpp.union_stack(trees, mesh)
    xs, ys = ref._lm_data(rs, M, mb, T, vocab)
    step = jpp.make_pipeline_train_step(fns, jnll, meta, mesh,
                                        data_axis=data)
    loss, grads = step(stacked, xs, ys)
    return (dict(trees=_np_tree(trees), xs=np.asarray(xs),
                 ys=np.asarray(ys), fns="lm", S=S_, loss="nll", data=data),
            dict(loss=float(loss),
                 grads=[_jpaths(g) for g in jpp.union_unstack(grads, meta)]))


def _jax_funnel():
    M, mb = 4, 2
    rs = np.random.RandomState(5)
    widths = [8, 32, 16, 4, 6]
    trees = [{f"w{i}": jnp.asarray(
        rs.normal(0, .3, (widths[i], widths[i + 1])), jnp.float32)}
        for i in range(S)]
    fns = [lambda p, x, i=i: jnp.tanh(x @ p[f"w{i}"]) for i in range(S)]
    mesh = _jmesh((S,), ("pipe",))
    stacked, meta = jpp.union_stack(trees, mesh)
    xs = jnp.asarray(rs.normal(size=(M, mb, widths[0])), jnp.float32)
    ys = jnp.asarray(rs.normal(size=(M, mb, widths[-1])), jnp.float32)
    mse = lambda y, t: jnp.mean((y - t) ** 2)  # noqa: E731
    loss, grads = jpp.make_pipeline_train_step(fns, mse, meta, mesh)(
        stacked, xs, ys)
    return (dict(trees=_np_tree(trees), xs=np.asarray(xs),
                 ys=np.asarray(ys), fns="funnel", S=S, loss="mse"),
            dict(loss=float(loss),
                 grads=[_jpaths(g) for g in jpp.union_unstack(grads, meta)]))


def _jax_free_first_stage(M=3, mb=2, w=5):
    """A first stage with no parameters and inputs that need no gradient:
    GPipe's gradients through ``pipeline_apply_tree`` and the 1F1B
    step's, both of the MSE against ``ys``."""
    rs = np.random.RandomState(12)
    trees = [{}] + [{f"w{i}": jnp.asarray(rs.normal(0, .5, (w, w)),
                                          jnp.float32)} for i in range(1, S)]
    fns = [lambda p, x: jnp.tanh(x)] + [
        lambda p, x, i=i: jnp.tanh(x @ p[f"w{i}"]) for i in range(1, S)]
    mesh = _jmesh((S,), ("pipe",))
    stacked, meta = jpp.union_stack(trees, mesh)
    xs = jnp.asarray(rs.normal(size=(M, mb, w)), jnp.float32)
    ys = jnp.asarray(rs.normal(size=(M, mb, w)), jnp.float32)
    mse = lambda y, t: jnp.mean((y - t) ** 2)  # noqa: E731
    gpipe = jax.grad(lambda st: mse(jpp.pipeline_apply_tree(
        fns, st, meta, xs, mesh), ys))(stacked)
    loss, grads = jpp.make_pipeline_train_step(fns, mse, meta, mesh)(
        stacked, xs, ys)
    return (dict(trees=_np_tree(trees), xs=np.asarray(xs),
                 ys=np.asarray(ys), fns="free_first", S=S, loss="mse"),
            dict(loss=float(loss),
                 grads=[_jpaths(g) for g in jpp.union_unstack(grads, meta)],
                 gpipe_grads=[_jpaths(g) for g in
                              jpp.union_unstack(gpipe, meta)]))


def _jax_one_stage():
    """A pipe axis of 1: the whole model is one stage, the step's
    boundary buffer fp32 by the reference's rule."""
    M, mb = 3, 2
    rs = np.random.RandomState(8)
    trees = [{"w0": jnp.asarray(rs.normal(0, .3, (5, 7)), jnp.float32)}]
    mesh = _jmesh((1,), ("pipe",))
    stacked, meta = jpp.union_stack(trees, mesh)
    xs = jnp.asarray(rs.normal(size=(M, mb, 5)), jnp.float32)
    ys = jnp.asarray(rs.normal(size=(M, mb, 7)), jnp.float32)
    mse = lambda y, t: jnp.mean((y - t) ** 2)  # noqa: E731
    loss, grads = jpp.make_pipeline_train_step(
        [lambda p, x: jnp.tanh(x @ p["w0"])], mse, meta, mesh)(
        stacked, xs, ys)
    return (dict(trees=_np_tree(trees), xs=np.asarray(xs),
                 ys=np.asarray(ys), fns="funnel", S=1, loss="mse"),
            dict(loss=float(loss),
                 grads=[_jpaths(g) for g in jpp.union_unstack(grads, meta)]))


def _jax_apply_tree():
    D, T, vocab, M, mb = 16, 8, 32, 4, 2
    rs = np.random.RandomState(6)
    mesh = _jmesh((S,), ("pipe",))
    fns, trees = ref._lm_stages(rs, S, D, vocab)
    stacked, meta = jpp.union_stack(trees, mesh)
    xs, _ = ref._lm_data(rs, M, mb, T, vocab)
    outs = jpp.pipeline_apply_tree(fns, stacked, meta, xs, mesh)
    return (dict(trees=_np_tree(trees), xs=np.asarray(xs), fns="lm", S=S),
            dict(outs=np.asarray(outs)))


def _jax_pp_example(steps=8, lr=0.3):
    """train_pp.py's main loop at its defaults on (data 2, pipe 2)."""
    ex = _load("examples/transformer-lm/train_pp.py", "_train_pp_example")
    stages, dp, D, heads, T, vocab, M, mb = 2, 2, 32, 2, 16, 64, 4, 4
    mesh = _jmesh((dp, stages), ("data", "pipe"))
    rs = np.random.RandomState(0)
    fns, trees = ex.make_stages(rs, stages, 1, D, vocab, heads)
    stacked, meta = jpp.union_stack(trees, mesh)
    step = jpp.make_pipeline_train_step(fns, ex.token_nll, meta, mesh,
                                        data_axis="data")
    X = rs.randint(0, vocab, (M, mb, T))
    Y = (X * 5 + 3) % vocab
    xs, ys = jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32)
    case = dict(trees=_np_tree(trees), xs=np.asarray(xs), ys=np.asarray(ys),
                fns="pp", S=stages, D=D, vocab=vocab, heads=heads,
                data="data", steps=steps, lr=lr)
    losses = []
    for _ in range(steps):
        loss, grads = step(stacked, xs, ys)
        stacked = jax.tree_util.tree_map(lambda w, g: w - lr * g, stacked,
                                         grads)
        losses.append(float(loss))
    return case, dict(losses=losses)


@pytest.fixture(scope="module")
def runs():
    pipe4 = dict(mesh=(S,), axes=("pipe",))
    dp_pp = dict(mesh=(2, 2), axes=("data", "pipe"))
    jax_runs, cases = {}, []
    for name, c in _jax_ppermute().items():
        jax_runs[name] = c
        cases.append(dict(pipe4, name=name, kind="ppermute", x=c["x"],
                          w=c["w"], perm=c["perm"]))
    c = _jax_apply()
    jax_runs["apply"] = c
    cases.append(dict(pipe4, name="apply", kind="apply", **{
        k: c[k] for k in ("stacked", "x", "n_micro")}))
    c = _jax_apply_grads()
    jax_runs["apply_grads"] = c
    cases.append(dict(pipe4, name="apply_grads", kind="apply_grads", **{
        k: c[k] for k in ("stacked", "x", "y", "n_micro")}))
    for name, remat, steps in (("tlm", False, 0), ("tlm_remat", True, 12)):
        case, jax_runs[name] = _jax_tlm(remat, steps)
        cases.append(dict(pipe4, name=name, kind="tlm", **case))
    case, jax_runs["lstm"] = _jax_lstm()
    cases.append(dict(pipe4, name="lstm", kind="lstm", **case))
    case, jax_runs["1f1b"] = _jax_1f1b(3, S, 6, 2, (S,), ("pipe",))
    cases.append(dict(pipe4, name="1f1b", kind="gpipe_vs_1f1b", **case))
    case, jax_runs["1f1b_dp_pp"] = _jax_1f1b(4, 2, 4, 4, (2, 2),
                                             ("data", "pipe"), "data")
    cases.append(dict(dp_pp, name="1f1b_dp_pp", kind="1f1b", **case))
    case, jax_runs["funnel"] = _jax_funnel()
    cases.append(dict(pipe4, name="funnel", kind="1f1b", **case))
    case, jax_runs["free_first"] = _jax_free_first_stage()
    cases.append(dict(pipe4, name="free_first", kind="free_first", **case))
    case, jax_runs["apply_tree"] = _jax_apply_tree()
    cases.append(dict(pipe4, name="apply_tree", kind="apply_tree", **case))
    case, jax_runs["pp_example"] = _jax_pp_example()
    cases.append(dict(dp_pp, name="pp_example", kind="pp_example", **case))
    port = worlds.run_world(4, "pipe_scenarios", cases)
    one = dict(mesh=(1,), axes=("pipe",))
    case, jax_runs["one_stage"] = _jax_one_stage()
    port.update(worlds.run_world(1, "pipe_scenarios", [
        dict(one, name="world1", kind="ppermute_world1"),
        dict(one, name="one_stage", kind="1f1b", **case)]))
    return {"jax": jax_runs, "port": port}


def _grads_match(got, want, what=""):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{what} {k}",
                                   **GRAD_TOL)


# ------------------------------------------------------------ ppermute
@pytest.mark.parametrize("name", ["cyclic", "partial"])
def test_ppermute_matches_jax(runs, name):
    """``dist.ppermute`` against ``jax.lax.ppermute`` under ``shard_map``:
    values (zeros where no rank sends) and the gradient, which travels
    the inverse permutation; a pair list that is no permutation refused
    before any exchange."""
    got, want = runs["port"][name], runs["jax"][name]
    np.testing.assert_array_equal(got["y"], want["y"])
    np.testing.assert_array_equal(got["grad"], want["grad"])
    assert "is not a permutation" in got["refusal"]


# ------------------------------------------------- the reference's cases
def test_pipeline_matches_sequential(runs):
    got, want = runs["port"]["apply"], runs["jax"]["apply"]
    np.testing.assert_allclose(got["out"], want["out"], rtol=1e-5,
                               atol=1e-5)
    ref_out = want["x"]
    for s in range(S):
        ref_out = np.tanh(ref_out @ want["stacked"]["w"][s]
                          + want["stacked"]["b"][s])
    np.testing.assert_allclose(got["out"].reshape(ref_out.shape), ref_out,
                               rtol=1e-5, atol=1e-5)


def test_pipeline_training_step_matches_dense(runs):
    """Gradients through the port's GPipe against ``jax.grad`` of the
    reference's: each rank's stage block of the sharded gradient."""
    got, want = runs["port"]["apply_grads"], runs["jax"]["apply_grads"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    _grads_match(got["grads"], want["grads"])


def test_pipeline_transformer_grads_match_sequential(runs):
    """The 4-stage transformer trunk: embed and head outside the
    pipeline (replicated: the input's gradient summed over the stages),
    the trunk's gradients in each stage's block."""
    got, want = runs["port"]["tlm"], runs["jax"]["tlm"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    _grads_match(got["grads"], want["grads"])


def test_pipeline_transformer_trains_with_remat(runs):
    """12 SGD steps with ``remat=True`` (each stage call checkpointed):
    the port's losses against the reference's at every step, falling as
    the reference's test asks; the GPipe bubble."""
    got = runs["port"]["tlm_remat"]["losses"]
    want = runs["jax"]["tlm_remat"]["losses"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0] - 0.1, got
    assert abs(tpp.bubble_fraction(4, 4) - 3 / 7) < 1e-12
    assert tpp.bubble_fraction(4, 4) == jpp.bubble_fraction(4, 4)
    assert tpp.bubble_fraction_1f1b(4, 8) == jpp.bubble_fraction_1f1b(4, 8)


def test_lstm_pipeline_example_self_test(runs):
    """lstm_pipeline.py's self-test in the port: pipeline == sequential,
    and both == the reference's gradients."""
    got, want = runs["port"]["lstm"], runs["jax"]["lstm"]
    for name in ("pipe", "seq"):
        np.testing.assert_allclose(got[name]["loss"], want[name]["loss"],
                                   rtol=LOSS_RTOL)
        _grads_match(got[name]["grads"], want[name]["grads"], name)
    _grads_match(got["pipe"]["grads"], got["seq"]["grads"], "port")


def _check_1f1b(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert len(got["grads"]) == len(want["grads"])
    for s, (g, w) in enumerate(zip(got["grads"], want["grads"])):
        _grads_match(g, w, f"stage {s}")


def _check_dense(got):
    """The port's step against its one-process oracle (the stage chain
    run sequentially under autograd, ``chip_smoke.pp_dense_loss``)."""
    np.testing.assert_allclose(got["loss"], got["dense_loss"],
                               rtol=LOSS_RTOL)
    for g, w in zip(got["grads"], got["dense_grads"]):
        _grads_match(g, w, "dense")


def test_1f1b_transformer_full_model_matches_dense(runs):
    """The whole LM in 4 per-stage trees through the port's 1F1B step:
    loss and every stage's gradients against the reference's step and a
    dense oracle; GPipe through ``pipeline_apply_tree`` gives the same
    loss (tools/pipeline_memory.py's sanity check)."""
    got, want = runs["port"]["1f1b"], runs["jax"]["1f1b"]
    _check_1f1b(got, want)
    _check_dense(got)
    np.testing.assert_allclose(got["gpipe_loss"], got["loss"], rtol=1e-5)
    assert got["placements"] == "(Shard(dim=0),)"


def test_1f1b_dp_pp_composes(runs):
    """(data 2, pipe 2): per-rank batches halve, loss and gradients
    averaged over data, against the reference's step on the same mesh
    shape and a dense oracle."""
    got, want = runs["port"]["1f1b_dp_pp"], runs["jax"]["1f1b_dp_pp"]
    _check_1f1b(got, want)
    _check_dense(got)


def test_1f1b_shape_changing_boundaries(runs):
    """The funnel 8 -> 32 -> 16 -> 4 -> 6: the flat boundary buffer pads
    to the widest edge; and ``union_stack`` refuses same-named leaves of
    different shapes, in the reference's words."""
    _check_1f1b(runs["port"]["funnel"], runs["jax"]["funnel"])
    with pytest.raises(ValueError, match="must.*match|rename") as err:
        tpp.union_stack([{"w": torch.zeros(3, 3)}, {"w": torch.zeros(5, 5)}])
    assert "same-named leaves must match across stages" in str(err.value)


def test_pp_lm_example_converges(runs):
    """train_pp.py's loop on (data 2, pipe 2), 8 SGD steps at lr 0.3: the
    port's losses against the reference's at every step, and falling."""
    got = runs["port"]["pp_example"]["losses"]
    want = runs["jax"]["pp_example"]["losses"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]


def test_world_of_one(runs):
    """A pipe axis of 1: ``ppermute`` returns its input, and the 1F1B
    step (one stage, first and last) matches the reference's."""
    assert runs["port"]["world1"]["identity"] is True
    _check_1f1b(runs["port"]["one_stage"], runs["jax"]["one_stage"])


def test_first_stage_without_parameters(runs):
    """A first stage with no parameters, and inputs that need no
    gradient: every rank still runs GPipe's backward (the ranks agree on
    it from the leaves they all hold), and the gradients of both
    schedules match the reference's."""
    got, want = runs["port"]["free_first"], runs["jax"]["free_first"]
    _check_1f1b(got, want)
    for s, (g, w) in enumerate(zip(got["gpipe_grads"],
                                   want["gpipe_grads"])):
        _grads_match(g, w, f"GPipe stage {s}")


def test_1f1b_apply_tree_inference(runs):
    np.testing.assert_allclose(runs["port"]["apply_tree"]["outs"],
                               runs["jax"]["apply_tree"]["outs"],
                               rtol=2e-4, atol=1e-5)


# ------------------------------------------------------------ refusals
def _fake_mesh(n):
    """A port ``Mesh`` of ``n`` ranks on ``pipe`` without a process group
    (the shape checks run before any)."""
    return tmesh.Mesh(None, ("pipe",), np.arange(n), torch.device("cpu"))


@pytest.mark.parametrize("fn", ["make_pipeline_train_step",
                                "pipeline_apply_tree"])
def test_stage_count_mismatch_refused(fn):
    fns = [lambda p, x: x] * 3
    jmesh = _jmesh((S,), ("pipe",))
    with pytest.raises(ValueError) as jerr:
        if fn == "make_pipeline_train_step":
            jpp.make_pipeline_train_step(fns, jnll, None, jmesh)
        else:
            jpp.pipeline_apply_tree(fns, {}, None, jnp.zeros((2, 1)), jmesh)
    with pytest.raises(ValueError) as terr:
        if fn == "make_pipeline_train_step":
            tpp.make_pipeline_train_step(fns, jnll, None, _fake_mesh(S))
        else:
            tpp.pipeline_apply_tree(fns, {}, None, torch.zeros(2, 1),
                                    _fake_mesh(S))
    assert str(terr.value) == str(jerr.value)


def test_microbatch_refuses_an_uneven_batch():
    with pytest.raises(ValueError) as jerr:
        jpp.microbatch(jnp.zeros((10, 3)), 4)
    with pytest.raises(ValueError) as terr:
        tpp.microbatch(torch.zeros(10, 3), 4)
    assert str(terr.value) == str(jerr.value)
    assert tuple(tpp.microbatch(torch.zeros(8, 3), 4).shape) == (4, 2, 3)


# --------------------------------------------------------- the carry
def test_from_jax_tree_carries_stage_trees_and_unions():
    """JAX per-stage trees and their stacked union come across by path:
    the port's union keys are the reference's ``keystr`` strings, and
    ``union_unstack`` of the carried union gives the JAX trees back."""
    rs = np.random.RandomState(11)
    _, trees = ref._lm_stages(rs, 3, 8, 16)
    jstacked, jmeta = jpp.union_stack(trees)
    ttrees = convert.from_jax_tree(_np_tree(trees), device="cpu")
    tstacked, tmeta = tpp.union_stack(ttrees)
    carried = convert.from_jax_tree(_np_tree(jstacked), device="cpu")
    assert set(tstacked) == set(carried) == set(jstacked)
    assert tmeta.union.keys() == jmeta.union.keys()
    for k in jstacked:
        np.testing.assert_array_equal(tstacked[k].numpy(),
                                      np.asarray(jstacked[k]))
    for got, want in zip(tpp.union_unstack(carried, tmeta),
                         jpp.union_unstack(jstacked, jmeta)):
        gp = worlds._paths_np(got)
        wp = _jpaths(want)
        assert gp.keys() == wp.keys()
        for k in wp:
            np.testing.assert_array_equal(gp[k], wp[k])
    assert convert.from_jax_tree(jnp.ones(2, jnp.bfloat16),
                                 device="cpu").dtype == torch.bfloat16
    # UnionMeta.embed_grads: a stage's grad tree into its union slice
    like = {k: v[1] for k, v in tstacked.items()}
    got = tmeta.embed_grads(1, ttrees[1], like)
    want = jmeta.embed_grads(1, trees[1], {k: v[1] for k, v in
                                           jstacked.items()})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("mod", ["pipeline", "moe"])
def test_every_public_name_of_the_reference(mod):
    """Each public function and class the reference's module defines is
    in the port's, functions with the reference's parameters in order
    (the port may add keyword parameters after them)."""
    import importlib
    import inspect

    jmod = importlib.import_module(f"mxnet_tpu.parallel.{mod}")
    tmod = importlib.import_module(f"mxnet_tpu_torch.parallel.{mod}")
    names = [n for n, v in vars(jmod).items() if not n.startswith("_")
             and (inspect.isfunction(v) or inspect.isclass(v))
             and v.__module__ == jmod.__name__]
    assert names
    for n in names:
        assert hasattr(tmod, n), n
        jv, tv = getattr(jmod, n), getattr(tmod, n)
        if inspect.isfunction(jv):
            jp = list(inspect.signature(jv).parameters)
            tp = list(inspect.signature(tv).parameters)
            assert tp[:len(jp)] == jp, (n, jp, tp)
    assert set(names) <= set(tmod.__all__)
