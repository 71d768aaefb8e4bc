"""Gloo worlds for the port's mesh tests, on the CPU.

:func:`run_world` starts ``n`` processes (``spawn``: a fresh interpreter
each, which imports torch and the port and never JAX), gives each the
launcher's environment (``MXTPU_COORDINATOR`` naming a rendezvous store
the parent binds and holds, as ``python -m mxnet_tpu_torch.launch``
does, with ``TORCHELASTIC_USE_AGENT_STORE=True``, ``MXTPU_RANK``,
``MXTPU_NUM_WORKERS``), runs one of the scenario
functions below in every rank and returns rank 0's result: a dict of
numpy arrays and plain values, written to a pickle in a temporary
directory.  A rank that fails hands its traceback to the parent, which
raises it.  Each rank runs torch with one thread, so a world of four
shares the test worker's cores without oversubscribing them.
"""
import os
import pickle
import tempfile
import traceback

import numpy as np

WORLD_TIMEOUT_S = 240


def _child(rank, n, port, out_dir, name, args):
    os.environ.update(MXTPU_COORDINATOR=f"127.0.0.1:{port}",
                      TORCHELASTIC_USE_AGENT_STORE="True",
                      MXTPU_RANK=str(rank), MXTPU_NUM_WORKERS=str(n))
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        import torch

        torch.set_num_threads(1)
        res = globals()[name](rank, *args)
        with open(path, "wb") as f:
            pickle.dump(("ok", res), f)
    except BaseException:  # noqa: BLE001 — handed to the parent
        with open(path, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise
    finally:
        import torch.distributed as td

        if td.is_initialized():
            td.destroy_process_group()


def run_world(n, name, *args):
    """Run scenario ``name(rank, *args)`` in a gloo world of ``n``
    processes; rank 0's result."""
    import multiprocessing as mp

    import torch.distributed as td

    ctx = mp.get_context("spawn")
    # the world's rendezvous store listens before any rank starts
    store = td.TCPStore("127.0.0.1", 0, n, True, wait_for_workers=False)
    port = store.port
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=_child,
                             args=(r, n, port, out_dir, name, args))
                 for r in range(n)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(WORLD_TIMEOUT_S)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results = []
        for r in range(n):
            path = os.path.join(out_dir, f"rank{r}.pkl")
            if not os.path.exists(path):
                results.append(("error", f"rank {r} left no result "
                                          f"(exit {procs[r].exitcode})"))
                continue
            with open(path, "rb") as f:
                results.append(pickle.load(f))
    errors = [f"rank {r}:\n{res}" for r, (kind, res) in enumerate(results)
              if kind != "ok"]
    if errors:
        raise AssertionError("\n".join(errors))
    return results[0][1]


def _np(t):
    """A copy of ``t``'s full value (a replicated DTensor's is its own
    storage, which later steps update in place)."""
    from mxnet_tpu_torch.parallel import mesh as tmesh

    return tmesh.full_value(t).detach().float().cpu().numpy().copy()


# ------------------------------------------------------------ training
def _lm(cfg):
    from mxnet_tpu_torch.models import transformer

    return transformer.transformer_lm(**cfg)


def _trainer(net, mesh, weights, shapes, **kw):
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.parallel import mesh as tmesh
    from mxnet_tpu_torch.trainer import FusedTrainer

    rules = tmesh.megatron_rules() if mesh is not None and \
        "model" in mesh.axis_names else ()
    tr = FusedTrainer(net, mesh=mesh, sharding_rules=rules,
                      device=None if mesh is not None else "cpu", **kw)
    tr.init(**shapes)
    convert.load_trainer_params(tr, weights)
    return tr


def train_scenarios(rank, spec):
    """The training cases of ``tests/test_torch_mesh_train.py``: each
    entry of ``spec`` names a mesh, a net and its steps; the result maps
    each case to its outputs and final parameters (full values)."""
    from mxnet_tpu_torch.models import mlp
    from mxnet_tpu_torch.parallel import mesh as tmesh

    out = {}
    meshes = {}

    def mesh_of(shape, axes):
        key = (tuple(shape), tuple(axes))
        if key not in meshes:
            meshes[key] = tmesh.create_mesh(shape, axes, device="cpu")
        return meshes[key]

    for case in spec["cases"]:
        mesh = mesh_of(case["mesh"], case["axes"])
        net = (mlp.get_symbol(num_classes=10) if case["net"] == "mlp"
               else _lm(case["net"]))
        kw = dict(optimizer=case["optimizer"],
                  optimizer_params=case["opt"],
                  dtype=case.get("dtype", "float32"))
        tr = _trainer(net, mesh, case["weights"], case["shapes"], **kw)
        res = {"placements": {k: str(tuple(v.placements))
                              for k, v in tr.params.items()},
               "local_shapes": {k: tuple(v.to_local().shape)
                                for k, v in tr.params.items()}}
        batches = case["batches"]
        if case.get("step_multi"):
            twin = _trainer(net, mesh, case["weights"], case["shapes"], **kw)
            k = len(batches)
            stacked = {n: np.stack([b[n] for b in batches])
                       for n in batches[0]}
            multi = tr.step_multi(**stacked)
            eager = [twin.step(**b)[0] for b in batches]
            res["multi_out"] = _np(multi[0])
            res["eager_out"] = np.stack([_np(o) for o in eager])
            res["twin_params"] = {n: _np(v) for n, v in twin.params.items()}
            res["k"] = k
        else:
            res["outs"] = [_np(tr.step(**b)[0]) for b in batches]
        res["params"] = {n: _np(v) for n, v in tr.params.items()}
        res["opt_state"] = {n: [_np(s) for s in st]
                            for n, st in tr.opt_state.items()}
        if case.get("fit"):
            # one epoch of fit over two batches, after the steps
            from mxnet_tpu_torch import io as tio
            from mxnet_tpu_torch import metric as tmetric

            data, label = case["fit"]
            acc = tmetric.create("acc")
            tr.fit(tio.NDArrayIter(data, label, batch_size=len(label) // 2),
                   eval_metric=acc, num_epoch=1)
            res["fit_acc"] = acc.get()[1]
            res["fit_params"] = {n: _np(v) for n, v in tr.params.items()}
        if case.get("checkpoint"):
            tr.save_checkpoint(case["checkpoint"], 1,
                               save_optimizer_states=True)
            tr.save_state(case["checkpoint"] + "-state", background=False)
        out[case["name"]] = res
    return out


# ------------------------------------------------------------ decoding
def decode_scenarios(rank, params, num_layers, num_heads, max_len, tokens,
                     prefix):
    """``tests/test_decode.py:128-150`` on a 2-way ``model`` mesh: the
    prefill's logits, then step by step after a shorter prefill, and the
    caches' placement; plus greedy generation."""
    from mxnet_tpu_torch.models.decode import KVDecoder
    from mxnet_tpu_torch.parallel import mesh as tmesh

    mesh = tmesh.create_mesh((2,), ("model",), device="cpu")
    tp = KVDecoder(params, num_layers=num_layers, num_heads=num_heads,
                   max_len=max_len, mesh=mesh)
    _, full = tp.prefill(tokens)
    st, lt = tp.prefill(tokens[:, :prefix])
    steps = [lt.float().numpy()]
    for t in range(prefix, tokens.shape[1]):
        st, lt = tp.step(st, tokens[:, t])
        steps.append(lt.float().numpy())
    kc = st[0]
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.serving.paged_kv import PagedSlots

    try:
        PagedSlots(tp, num_slots=2)
        paged = None
    except MXNetError as exc:
        paged = str(exc)
    return {"prefill": full.float().numpy(), "steps": steps,
            "paged_refusal": paged,
            "placements": str(tuple(kc.placements)),
            "cache_shape": tuple(kc.shape),
            "local_cache_shape": tuple(kc.to_local().shape),
            "generate": tp.generate(tokens[:, :prefix], 6, temperature=0),
            "generate_scan": tp.generate_scan(tokens[:, :prefix], 6),
            "weight_bytes": tp.weight_bytes()}


# ------------------------------------------------- sequence parallelism
def seq_scenarios(rank, cases):
    """Ring and Ulysses attention over the meshes ``cases`` name: each
    output's full value, and with ``grad`` the gradients of
    ``sum(out ** 2)`` with respect to q, k and v (DTensor leaves placed
    as the function places them)."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from mxnet_tpu_torch.parallel import mesh as tmesh
    from mxnet_tpu_torch.parallel import ring_attention as ra

    out = {}
    meshes = {}
    for case in cases:
        key = (tuple(case["mesh"]), tuple(case["axes"]))
        if key not in meshes:
            meshes[key] = tmesh.create_mesh(case["mesh"], case["axes"],
                                            device="cpu")
        mesh = meshes[key]
        fn = getattr(ra, case["fn"])
        q, k, v = (torch.from_numpy(x) for x in case["qkv"])
        kw = dict(causal=case["causal"], batch_axis=case.get("batch_axis"))
        if not case.get("grad"):
            out[case["name"]] = {"out": _np(fn(q, k, v, mesh, "seq", **kw))}
            continue
        sh = tmesh.NamedSharding(mesh, (kw["batch_axis"], None, "seq", None))
        leaves = [distribute_tensor(x, mesh.device_mesh, sh.placements,
                                    src_data_rank=None).requires_grad_(True)
                  for x in (q, k, v)]
        o = fn(*leaves, mesh, "seq", **kw)
        (o ** 2).sum().backward()
        out[case["name"]] = {"out": _np(o.detach()),
                             "grads": [_np(x.grad) for x in leaves]}
    return out


# ------------------------------------------ pipeline and expert parallel
def _stage_fn(params, x, stage):
    """``tests/test_pipeline_moe.py:_stage_fn``."""
    import torch

    return torch.tanh(x @ params["w"] + params["b"])


def _tblock(p, h):
    """``tests/test_pipeline_moe.py:_tblock``: the pre-LN block with a
    packed q|k|v (``x @ W.T``), 2 heads, a -1e9 causal mask."""
    import math

    import torch

    import chip_smoke as cs

    mb, T, D = h.shape
    H, dh = 2, D // 2
    x = cs.lm_layer_norm(h, p["ln1_g"], p["ln1_b"])
    q, k, v = (x @ p["qkv_w"].T + p["qkv_b"]).chunk(3, dim=-1)

    def sh(a):
        return a.reshape(mb, T, H, dh).transpose(1, 2)

    q, k, v = sh(q), sh(k), sh(v)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
    mask = torch.ones((T, T), dtype=torch.bool, device=h.device).tril()
    scores = torch.where(mask, scores, -1e9)
    att = (torch.softmax(scores, -1) @ v).transpose(1, 2).reshape(mb, T, D)
    h = h + att @ p["proj_w"].T + p["proj_b"]
    x = cs.lm_layer_norm(h, p["ln2_g"], p["ln2_b"])
    f = torch.nn.functional.gelu(x @ p["fi_w"].T + p["fi_b"],
                                 approximate="tanh")
    return h + f @ p["fo_w"].T + p["fo_b"]


def _lm_stage_fns(S):
    """The stage functions of ``tests/test_pipeline_moe.py:_lm_stages``."""
    import chip_smoke as cs

    def trunk(p, h):
        for i in range(next(iter(p.values())).shape[0]):
            h = _tblock({k: v[i] for k, v in p.items()}, h)
        return h

    fns = []
    for s in range(S):
        if s == 0:
            fns.append(lambda p, ids: trunk(p["blocks"],
                                            p["embed"][ids.long()]))
        elif s == S - 1:
            fns.append(lambda p, h: cs.lm_layer_norm(
                trunk(p["blocks"], h), p["lnf_g"], p["lnf_b"]) @ p["head"])
        else:
            fns.append(lambda p, h: trunk(p["blocks"], h))
    return fns


def _stage_fns(case):
    import torch

    import chip_smoke as cs

    kind = case["fns"]
    if kind == "lm":
        return _lm_stage_fns(case["S"])
    if kind == "funnel":
        return [lambda p, x, i=i: torch.tanh(x @ p[f"w{i}"])
                for i in range(case["S"])]
    if kind == "free_first":
        return [lambda p, x: torch.tanh(x)] + [
            lambda p, x, i=i: torch.tanh(x @ p[f"w{i}"])
            for i in range(1, case["S"])]
    # train_pp's own stages: the structure from a throwaway generator
    gen = torch.Generator().manual_seed(0)
    return cs.pp_make_stages(gen, case["S"], 1, case["D"], case["vocab"],
                             case["heads"])[0]


def _loss_fn(name):
    import torch

    from mxnet_tpu_torch.ops.loss import token_nll

    if name == "mse":
        return lambda y, t: torch.mean((y - t) ** 2)
    return token_nll


def _paths_np(tree):
    """{keystr path: numpy} of a tree of tensors."""
    from torch.utils import _pytree as pytree

    return {pytree.keystr(p): _np(v)
            for p, v in pytree.tree_flatten_with_path(tree)[0]}


def pipe_scenarios(rank, cases):
    """The cases of ``tests/test_torch_pipeline.py`` over the meshes they
    name; each result holds full values (gathered: gloo on the CPU)."""
    import torch

    import chip_smoke as cs
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.parallel import dist as tdist
    from mxnet_tpu_torch.parallel import mesh as tmesh
    from mxnet_tpu_torch.parallel import pipeline as tpp

    def t(a):
        return convert.from_jax_tree(a, device="cpu")

    out = {}
    meshes = {}
    for case in cases:
        key = (tuple(case["mesh"]), tuple(case["axes"]))
        if key not in meshes:
            meshes[key] = tmesh.create_mesh(case["mesh"], case["axes"],
                                            device="cpu")
        mesh = meshes[key]
        kind = case["kind"]
        res = {}
        if kind == "ppermute_world1":
            x = torch.ones(3)
            res["identity"] = tdist.ppermute(
                x, mesh.get_group("pipe"), [(0, 0)]) is x
        elif kind == "ppermute":
            group = mesh.get_group("pipe")
            me = mesh.coordinate("pipe")
            x = torch.from_numpy(case["x"][me]).requires_grad_(True)
            y = tdist.ppermute(x, group, case["perm"])
            (y * torch.from_numpy(case["w"][me])).sum().backward()
            res = {"y": _gather_rows(y.detach(), mesh),
                   "grad": _gather_rows(x.grad, mesh)}
            try:
                tdist.ppermute(x, group, [(0, 1), (1, 1)])
            except ValueError as exc:
                res["refusal"] = str(exc)
        elif kind in ("apply", "apply_grads"):
            stacked = tpp.shard_stacked(mesh, t(case["stacked"]))
            for v in stacked.values():
                v.requires_grad_(True)
            xs = tpp.microbatch(t(case["x"]), case["n_micro"])
            outs = tpp.pipeline_apply(_stage_fn, stacked, xs, mesh, "pipe")
            res["out"] = _np(outs.detach())
            if kind == "apply_grads":
                w = case["x"].shape[1]
                loss = torch.mean((outs.reshape(-1, w) - t(case["y"])) ** 2)
                loss.backward()
                res["loss"] = float(loss)
                res["grads"] = {k: _np(v.grad) for k, v in stacked.items()}
        elif kind == "tlm":
            res = _tlm_case(case, mesh, t)
        elif kind == "lstm":
            params = t(case["params"])
            params["trunk"] = tpp.shard_stacked(mesh, params["trunk"])
            X, Y = t(case["X"]), t(case["Y"])
            pipe_loss, seq_loss = cs.lstm_pp_make_losses(
                mesh, case["n_micro"], X, Y, case["vocab"])
            for name, fn in (("pipe", pipe_loss), ("seq", seq_loss)):
                leaves = _grad_leaves(params)
                loss = fn(params)
                loss.backward()
                res[name] = {"loss": float(loss),
                             "grads": {k: _np(v.grad) for k, v in
                                       leaves.items()}}
                for v in leaves.values():
                    v.grad = None
        elif kind in ("1f1b", "apply_tree", "gpipe_vs_1f1b"):
            fns = _stage_fns(case)
            stacked, meta = tpp.union_stack(t(case["trees"]), mesh)
            xs = t(case["xs"])
            if kind == "apply_tree":
                outs = tpp.pipeline_apply_tree(fns, stacked, meta, xs, mesh,
                                               data_axis=case.get("data"))
                res["outs"] = _np(outs)
            else:
                step = tpp.make_pipeline_train_step(
                    fns, _loss_fn(case["loss"]), meta, mesh,
                    data_axis=case.get("data"))
                loss, grads = step(stacked, xs, t(case["ys"]))
                res["loss"] = float(loss)
                res["grads"] = [_paths_np(tree) for tree in
                                tpp.union_unstack(grads, meta)]
                res["placements"] = str(tuple(
                    next(iter(grads.values())).placements))
                if case["fns"] == "lm":
                    trees = t(case["trees"])
                    leaves = [_grad_leaves(tree) for tree in trees]
                    dense = cs.pp_dense_loss(fns, trees, xs, t(case["ys"]))
                    dense.backward()
                    res["dense_loss"] = float(dense)
                    res["dense_grads"] = [{k: _np(v.grad) for k, v in
                                           lv.items()} for lv in leaves]
                if kind == "gpipe_vs_1f1b":
                    res["gpipe_loss"] = float(cs.pp_gpipe_loss(
                        fns, stacked, meta, xs, t(case["ys"]), mesh))
        elif kind == "free_first":
            fns = _stage_fns(case)
            stacked, meta = tpp.union_stack(t(case["trees"]), mesh)
            xs, ys = t(case["xs"]), t(case["ys"])
            for v in stacked.values():
                v.requires_grad_(True)
            outs = tpp.pipeline_apply_tree(fns, stacked, meta, xs, mesh)
            torch.mean((outs - ys) ** 2).backward()
            res["gpipe_grads"] = [_paths_np(tree) for tree in
                                  tpp.union_unstack(
                                      {k: v.grad for k, v in stacked.items()},
                                      meta)]
            loss, grads = tpp.make_pipeline_train_step(
                fns, _loss_fn("mse"), meta, mesh)(stacked, xs, ys)
            res["loss"] = float(loss)
            res["grads"] = [_paths_np(tree) for tree in
                            tpp.union_unstack(grads, meta)]
        elif kind == "pp_example":
            res = _pp_example(case, mesh, t)
        out[case["name"]] = res
    return out


def _gather_rows(x, mesh):
    """Every rank's ``x`` stacked in rank order (an all-gather on the
    CPU)."""
    import torch
    import torch.distributed as td

    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    td.all_gather(parts, x.contiguous())
    return torch.stack(parts).numpy()


def _grad_leaves(params):
    """The floating leaves of a dict tree, made to require grad."""
    from torch.utils import _pytree as pytree

    leaves = {pytree.keystr(p): v for p, v in
              pytree.tree_flatten_with_path(params)[0]}
    for v in leaves.values():
        v.requires_grad_(True)
    return leaves


def _tlm_case(case, mesh, t):
    """``_pipelined_lm``: embed and head outside the pipeline, the 4-block
    trunk through ``pipeline_apply``; the loss and gradients, or the
    losses of ``steps`` SGD steps."""
    import torch

    from mxnet_tpu_torch.parallel import pipeline as tpp

    params = t(case["params"])
    params["trunk"] = tpp.shard_stacked(mesh, params["trunk"])
    X, Y = t(case["X"]), t(case["Y"])
    T, D = X.shape[1], params["embed"].shape[1]
    stage_fn = tpp.stacked_blocks_stage(_tblock)

    def nll(logits):
        lp = torch.log_softmax(logits, dim=-1)
        return -lp.gather(-1, Y.reshape(-1, T).long()[..., None]).mean()

    def pipe_loss(p):
        h = p["embed"][X.long()]
        out = tpp.pipeline_apply(stage_fn, p["trunk"],
                                 tpp.microbatch(h, case["n_micro"]), mesh,
                                 "pipe", remat=case["remat"])
        return nll(out.reshape(-1, T, D) @ p["head"])

    leaves = _grad_leaves(params)
    if not case["steps"]:
        loss = pipe_loss(params)
        loss.backward()
        return {"loss": float(loss),
                "grads": {k: _np(v.grad) for k, v in leaves.items()}}
    losses = []
    for _ in range(case["steps"]):
        loss = pipe_loss(params)
        loss.backward()
        losses.append(float(loss))
        with torch.no_grad():
            for v in leaves.values():
                v.sub_(0.2 * v.grad)
                v.grad = None
    return {"losses": losses}


def _pp_example(case, mesh, t):
    """train_pp.py's loop through the port: its stages with the given
    trees, the 1F1B step over the case's mesh, SGD on the sharded
    parameters; the losses."""
    import torch

    from mxnet_tpu_torch.ops.loss import token_nll
    from mxnet_tpu_torch.parallel import pipeline as tpp

    fns = _stage_fns(case)
    stacked, meta = tpp.union_stack(t(case["trees"]), mesh)
    step = tpp.make_pipeline_train_step(fns, token_nll, meta, mesh,
                                        data_axis=case.get("data"))
    xs, ys = t(case["xs"]), t(case["ys"])
    losses = []
    for _ in range(case["steps"]):
        loss, grads = step(stacked, xs, ys)
        with torch.no_grad():
            stacked = {k: w - case["lr"] * grads[k]
                       for k, w in stacked.items()}
        losses.append(float(loss))
    return {"losses": losses}


def moe_scenarios(rank, cases):
    """The cases of ``tests/test_torch_moe.py`` on an ``expert`` mesh of
    the world's ranks; outputs gathered to full values."""
    import torch

    import chip_smoke as cs
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.parallel import mesh as tmesh
    from mxnet_tpu_torch.parallel import moe as tmoe

    def t(a):
        return convert.from_jax_tree(a, device="cpu")

    mesh = tmesh.create_mesh((4,), ("expert",), device="cpu")
    n = mesh.shape["expert"]
    out = {}
    for case in cases:
        kind = case["kind"]
        res = {}
        if kind == "ffn":
            x = t(case["x"])
            y, aux = tmoe.moe_ffn(t(case["params"]), x, mesh, "expert",
                                  capacity_factor=case["cf"],
                                  top_k=case["top_k"])
            res = {"y": _np(y), "aux": float(aux)}
            if case.get("routing"):
                xs = tmoe._local(x, tmesh.NamedSharding(mesh, ("expert",
                                                              None)))
                p = t(case["params"])
                probs = torch.softmax(
                    torch.matmul(*tmoe._promoted(xs, p["gate_w"])), -1)
                nt = xs.shape[0]
                cap = max(1, int(case["cf"] * case["top_k"] * nt / n))
                _, pos, keep, _, _ = tmoe.route(probs, case["top_k"], cap,
                                                xs.dtype)
                res["slots"] = _gather_rows(pos, mesh)
                res["keep"] = _gather_rows(keep, mesh)
        elif kind == "train":
            res = _moe_train(case, mesh, t)
        elif kind == "lm":
            params = cs.moe_place(t(case["params"]), mesh)
            X, Y = t(case["X"]), t(case["Y"])
            nlls, auxes = [], []
            for _ in range(case["steps"]):
                nll, aux = cs.moe_sgd_step(params, X, Y, case["heads"], mesh,
                                           case["top_k"], case["lr"],
                                           case["aux_weight"])
                nlls.append(float(nll))
                auxes.append(float(aux))
            res = {"nll": nlls, "aux": auxes}
        out[case["name"]] = res
    return out


def _moe_train(case, mesh, t):
    """``test_moe_trains``: mean((y - tgt)^2) + 0.01 aux over all tokens,
    each rank backpropagating its share (its mean over the ranks' count)
    and the replicated gate's gradient summed over the axis; ``steps``
    SGD steps at lr 0.3; the losses and the first step's gradients."""
    import torch
    import torch.distributed as td

    from mxnet_tpu_torch.parallel import mesh as tmesh
    from mxnet_tpu_torch.parallel import moe as tmoe

    n = mesh.shape["expert"]
    sh = tmesh.NamedSharding(mesh, ("expert", None, None))
    p = t(case["params"])
    params = {"gate_w": p["gate_w"].requires_grad_(True)}
    for k in ("w_in", "w_out"):
        params[k] = tmesh.from_block(tmesh.narrow_local(p[k], sh).clone(),
                                     mesh.device_mesh, sh.placements,
                                     p[k].shape).requires_grad_(True)
    x = t(case["x"])
    tgt = tmoe._local(t(case["tgt"]), tmesh.NamedSharding(mesh, ("expert",
                                                                 None)))
    losses, first = [], None
    for i in range(case["steps"]):
        y, aux = tmoe.moe_ffn(params, x, mesh, "expert",
                              top_k=case["top_k"])
        mse = torch.mean((y.to_local() - tgt) ** 2)
        ((mse + 0.01 * aux) / n).backward()
        td.all_reduce(params["gate_w"].grad, group=mesh.get_group("expert"))
        tot = mse.detach().clone()
        td.all_reduce(tot, group=mesh.get_group("expert"))
        losses.append(float(tot / n + 0.01 * aux))
        if i == 0:
            first = {k: _np(v.grad) for k, v in params.items()}
        with torch.no_grad():
            for v in params.values():
                assert torch.isfinite(tmesh.full_value(v.grad)).all()
                v.sub_(0.3 * v.grad)
                v.grad = None
    return {"losses": losses, "grads": first}


# ---------------------------------------- Module and KVStore across ranks
def _ranks_equal(arrays):
    """Whether every rank holds the same bits in each of ``arrays``
    (numpy; gathered through one all-gather a tensor)."""
    import torch
    import torch.distributed as td

    ok = True
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a)).reshape(-1)
        got = [torch.empty_like(t) for _ in range(td.get_world_size())]
        td.all_gather(got, t)
        ok = ok and all(torch.equal(got[0], g) for g in got[1:])
    return ok


def _env(over):
    """Set the env knobs of a case; returns the previous values."""
    prev = {k: os.environ.get(k) for k in over}
    for k, v in over.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return prev


def _collective_store(rank, case):
    """A collective ``dist_sync`` store over the world: every rank pushes
    its own gradients (``case["grads"][step][rank]``) for ``steps``
    steps; the weights, the state after ``ensure_host_state``, the state
    bytes the rank held, and the telemetry counts."""
    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch import telemetry as ttm

    prev = _env(case.get("env", {}))
    try:
        amp.reset_scaler()
        ttm.reset()
        ttm.enable()
        kv = tmx.kv.create("dist_sync")
        opt = tmx.optimizer.create(case["opt"], **case["opt_params"])
        opt.set_lr_mult(case.get("lr_mult", {}))
        kv.set_optimizer(opt)
        dt = getattr(torch, case.get("dtype", "float32"))
        keys = list(range(len(case["init"])))
        with tmx.Context("cpu"):
            # rank 1 starts elsewhere: init must hand it rank 0's values
            kv.init(keys, [tmx.nd.NDArray(torch.from_numpy(
                a * (1 + rank)).to(dt)) for a in case["init"]])
            outs = [tmx.nd.NDArray(torch.zeros(a.shape, dtype=dt))
                    for a in case["init"]]
            for t, step_grads in enumerate(case["grads"]):
                grads = [tmx.nd.NDArray(torch.from_numpy(g).to(dt))
                         for g in step_grads[rank]]
                if t in case.get("eager_steps", ()):
                    # one key at a time: the eager per-key path, which
                    # gathers the sharded states back first
                    for k, g in zip(keys, grads):
                        kv.push(k, g)
                else:
                    kv.push(keys, [[g] for g in grads])
                kv.pull(keys, outs)
                if t in case.get("reload_after", ()):
                    # save_optimizer_states / load_optimizer_states
                    kv._updater.set_states(kv._updater.get_states())
        eng = kv._fused
        res = {"collective": kv.collective, "rank": kv.rank,
               "size": kv.num_workers,
               "shard_n": [b.shard_n for b in eng._buckets],
               "state_bytes": eng.optimizer_state_bytes(),
               "weights": [o.tensor.float().numpy().copy() for o in outs]}
        if amp.scaling_active():
            res["scaler"] = amp.global_scaler().report()
        states = kv._updater.get_states()  # gathers the shards back
        res["states"] = states
        reg = ttm.get_registry()
        res["allreduce_bytes"] = reg.get("dist_allreduce_bytes_total")\
            .value()
        res["collective_bytes"] = {
            op: reg.get("executor_collective_bytes_total").value(op=op)
            for op in ("grad_allreduce", "kv_grad_shard",
                       "kv_param_allgather")}
        res["gather_count"] = reg.get("kvstore_shard_gather_seconds")\
            .count(store="dist_sync")
        res["ranks_equal"] = _ranks_equal(res["weights"])
        return res
    finally:
        _env(prev)
        amp.reset_scaler()


def _collective_fit(rank, case):
    """``Module.fit`` over the collective ``dist_sync``: each rank binds
    the host and trains on its half of every global batch."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import io as tio
    from mxnet_tpu_torch import symbol as tsym

    prev = _env(case.get("env", {}))
    try:
        x, y = case["data"]
        half = case["batch"] // 2
        rows = np.concatenate([np.arange(s + rank * half, s + (rank + 1)
                                         * half)
                               for s in range(0, len(y), case["batch"])])
        it = tio.NDArrayIter(x[rows], y[rows], batch_size=half,
                             shuffle=False)
        mod = tmx.mod.Module(tsym.load_json(case["net"]),
                             context=tmx.cpu())
        mod.fit(it, optimizer=case["opt"], kvstore="dist_sync",
                optimizer_params=tuple(case["opt_params"].items()),
                num_epoch=case["epochs"], arg_params=case["arg_params"],
                aux_params=case.get("aux_params"))
        args, _ = mod.get_params()
        out = {k: v.tensor.float().numpy().copy() for k, v in args.items()}
        return {"params": out, "ranks_equal": _ranks_equal(
            [out[k] for k in sorted(out)]),
            "rescale_grad": mod._optimizer.rescale_grad}
    finally:
        _env(prev)


def _collective_syncs(rank, case):
    """Host reads of tensors in a collective ``Module.fit`` of ``n``
    batches a rank (fused metrics): the per-batch count is 0."""
    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import io as tio
    from mxnet_tpu_torch import symbol as tsym

    names = ("item", "cpu", "tolist", "numpy", "__bool__", "__float__",
             "__int__")
    counts = {}
    for n in case["nbatch"]:
        rs = np.random.RandomState(9 + rank)
        x = rs.uniform(-1, 1, (16 * n, 10)).astype(np.float32)
        y = (x.sum(axis=1) > 0).astype(np.float32)
        it = tio.NDArrayIter(x, y, batch_size=16, shuffle=False)
        mod = tmx.mod.Module(tsym.load_json(case["net"]),
                             context=tmx.cpu())
        seen = []
        origs = {k: getattr(torch.Tensor, k) for k in names}

        def counted(name):
            def f(*a, **kw):
                seen.append(name)
                return origs[name](*a, **kw)
            return f

        try:
            for k in names:
                setattr(torch.Tensor, k, counted(k))
            mod.fit(it, optimizer="sgd", kvstore="dist_sync",
                    optimizer_params=(("learning_rate", 0.1),),
                    eval_metric=["acc", "ce"], num_epoch=1)
        finally:
            for k, f in origs.items():
                setattr(torch.Tensor, k, f)
        counts[n] = len(seen)
    return counts


def _mesh_metric_sentinel(rank, case):
    """``FusedTrainer`` on a (2, 1) mesh with ``MXTPU_SENTINEL`` on:
    the sentinel's packed flags and norm of each step, then ``fit``'s
    fused metrics over the global batches, and the metrics' host reads."""
    from mxnet_tpu_torch import io as tio
    from mxnet_tpu_torch import metric as tmetric
    from mxnet_tpu_torch import symbol as tsym
    from mxnet_tpu_torch import telemetry as ttm
    from mxnet_tpu_torch.parallel import mesh as tmesh

    prev = _env({"MXTPU_SENTINEL": "warn"})
    try:
        ttm.reset()
        ttm.enable()
        ttm.health._pending.clear()
        mesh = tmesh.create_mesh((2, 1), ("data", "model"), device="cpu")
        tr = _trainer(tsym.load_json(case["net"]), mesh, case["weights"],
                      case["shapes"], optimizer="sgd",
                      optimizer_params=case["opt_params"])
        for b in case["batches"]:
            tr.step(**b)
        sent = [r["finite"].numpy().copy() for r in ttm.health._pending]
        ttm.health._pending.clear()
        x, y = case["fit"]
        metric = tmetric.create(["acc", "ce"])
        tr.fit(tio.NDArrayIter(x, y, batch_size=case["fit_batch"],
                               shuffle=False),
               eval_metric=metric, num_epoch=1)
        reg = ttm.get_registry().get("metric_host_sync_total")
        return {"sentinel": sent,
                "metric": metric.get_global_name_value(),
                "metric_syncs": {m: reg.value(metric=m)
                                 for m in ("accuracy", "cross-entropy")},
                "params": {n: _np(v) for n, v in tr.params.items()}}
    finally:
        _env(prev)
        ttm.health._pending.clear()


def _sharded_table(rank, case):
    """A row-sparse table split by rows over a (2,) mesh in a ``device``
    store: the same pushes on every rank update each rank's block; the
    pull gathers the table."""
    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import sparse as tsparse
    from mxnet_tpu_torch.parallel import mesh as tmesh

    mesh = tmesh.create_mesh((2,), ("data",), device="cpu")
    kv = tmx.kv.create("device")
    kv.set_optimizer(tmx.optimizer.create("adam", learning_rate=0.05,
                                          rescale_grad=1.0))
    with tmx.Context("cpu"):
        kv.init(0, tsparse.full_row_sparse(tmx.nd.array(case["table"])))
        table = tmesh.shard_params(mesh, {"t": kv._store[0].tensor}, [
            tmesh.ShardingRule("t", ("data", None))])["t"]
        kv._store[0] = tmx.nd.NDArray(table)
        for idx, vals in case["pushes"]:
            kv.push([0], [[tsparse.RowSparseNDArray(
                torch.from_numpy(idx.astype(np.int32)),
                torch.from_numpy(vals), case["table"].shape)]])
        out = tmx.nd.zeros(case["table"].shape)
        kv.pull([0], [out])
    return {"table": out.tensor.numpy().copy(),
            "placements": str(tuple(kv._store[0].tensor.placements)),
            "local_rows": int(kv._store[0].tensor.to_local().shape[0])}


def _collective_refusals(rank, case):
    """What the collective store refuses over a world of 2: a row-sparse
    push (its message)."""
    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import sparse as tsparse
    from mxnet_tpu_torch.base import MXNetError

    kv = tmx.kv.create("dist_sync")
    with tmx.Context("cpu"):
        kv.init(0, tsparse.full_row_sparse(tmx.nd.zeros((4, 2))))
        try:
            kv.push(0, tsparse.RowSparseNDArray(
                torch.tensor([1], dtype=torch.int32), torch.ones(1, 2),
                (4, 2)))
        except MXNetError as exc:
            return {"row_sparse": str(exc)}
    return {"row_sparse": None}


def collective_scenarios(rank, spec):
    """The cases of ``tests/test_torch_collective_world.py`` in one
    world: each entry of ``spec`` is ``(kind, name, case)``."""
    kinds = {"store": _collective_store, "fit": _collective_fit,
             "syncs": _collective_syncs, "mesh": _mesh_metric_sentinel,
             "table": _sharded_table, "refusals": _collective_refusals}
    return {name: kinds[kind](rank, case) for kind, name, case in spec}
