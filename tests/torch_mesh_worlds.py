"""Gloo worlds for the port's mesh tests, on the CPU.

:func:`run_world` starts ``n`` processes (``spawn``: a fresh interpreter
each, which imports torch and the port and never JAX), gives each the
launcher's environment (``MXTPU_COORDINATOR`` on a free loopback port,
``MXTPU_RANK``, ``MXTPU_NUM_WORKERS``), runs one of the scenario
functions below in every rank and returns rank 0's result: a dict of
numpy arrays and plain values, written to a pickle in a temporary
directory.  A rank that fails hands its traceback to the parent, which
raises it.  Each rank runs torch with one thread, so a world of four
shares the test worker's cores without oversubscribing them.
"""
import os
import pickle
import socket
import tempfile
import traceback

import numpy as np

WORLD_TIMEOUT_S = 240


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank, n, port, out_dir, name, args):
    os.environ.update(MXTPU_COORDINATOR=f"127.0.0.1:{port}",
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

    ctx = mp.get_context("spawn")
    port = _free_port()
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
