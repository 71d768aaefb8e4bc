"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu.

A second package beside ``mxnet_tpu`` (the JAX reference, which it never
imports).  Plain tensor code is PyTorch; every kernel the JAX package
wrote in Pallas becomes a hand-written CUDA kernel for Hopper (sm_90a),
with a plain PyTorch version beside it for CPU tensors.

Ported so far: the paged decode-serving path — ``models.decode.
KVDecoder``, ``serving.PagedSlots``/``SlotScheduler``/``serve_decoder``
and the paged decode-attention kernel ``ops.paged_attention``; the
transformer-LM training step — ``models.transformer.transformer_lm``
over ``symbol``/``executor``/``ops``, ``trainer.FusedTrainer`` and the
flash-attention forward, dQ and dK/dV kernels ``ops.flash_attention``;
ResNet inference through ``predict.Predictor`` after the graph passes,
with the residual-epilogue kernel ``ops.residual_epilogue``; and the
imperative half — ``nd`` (``NDArray`` over the op registry, the
generated ``nd.<op>`` functions, ``save``/``load``), checkpoints
(``model.save_checkpoint``/``load_checkpoint``, ``predict.create``) and
``rtc.Rtc``, user CUDA C compiled by NVRTC; and ResNet-50 training —
``models.get_symbol``, ``trainer.FusedTrainer`` with channels-last conv
weights, ``step_multi`` as one captured CUDA graph per step, and ``fit``
over ``io.NDArrayIter`` with ``metric``, ``callback``, ``lr_scheduler``,
``initializer`` and the ``engine.AsyncWindow``; and MXNet's training
API — the ``Executor`` forward and backward, ``optimizer`` with its
``Updater``, the local ``kvstore`` with the bucketed update of
``kvstore_fused``, and ``module.Module`` (bind, fit, score, predict,
checkpoints); and mixed precision — ``amp`` (the ``MXTPU_AMP`` policy,
fp32 masters and the device-resident ``LossScaler``) with the whole
graph-pass pipeline of ``passes`` (``constant_fold``, ``cse``, ``dce``,
``residual_epilogue``, ``amp_cast``, ``prefuse``, ``convbn_fold``); and
the image-classification zoo; and the LSTM language model —
``models.lstm``, ``rnn`` (the cells, ``FusedRNNCell`` over the ``RNN``
op, ``BucketSentenceIter``) and ``mod.BucketingModule``; and training
from RecordIO — ``recordio``, ``filesystem`` (local, ``mem://``,
``InputSplit``), the native record reader and JPEG decoder of
``_native``, ``image`` (augmenters, ``ImageIter``, ``ImageRecordIter``,
``MultiProcessImageRecordIter`` of ``mp_io``), the pinned staging pool
``storage``, ``io.PrefetchingIter``/``DevicePrefetchIter``/
``MNISTIter``/``CSVIter``, ``monitor.Monitor``, ``mod.SequentialModule``/
``PythonModule`` and the rest of the initializers; and training that
survives a crash — ``checkpoint`` (manifest-last atomic publishes,
``FusedTrainer.save_state``/``restore_state``, ``fit(checkpoint=,
resume=)``, preemption) — and row-sparse training — ``sparse``
(``RowSparseNDArray``, also ``nd.sparse``) through the executor, the
optimizer rules, the kvstore and its fused buckets — with the rest of
``Symbol`` and ``Executor`` (``structural_signature``, the program
cache, attrs, ``infer_type``, nnvm JSON) and ``FusedTrainer(remat=True)``;
and MXNet's classic top-level surface — ``Context`` (``cpu_pinned``,
``tpu``, ``num_devices``, ``with ctx:`` scoping), ``random``,
``resource``, ``operator`` with the ``Custom`` op, ``profiler`` (host
spans and a ``torch.profiler`` device trace), ``faults``
(``MXTPU_FAULT_PLAN``), ``executor_manager``, ``model.FeedForward``,
``visualization`` and ``test_utils``; and MXNet's parameter-server
training — ``kvstore_server`` and the ``dist_sync``/``dist_device_sync``/
``dist_async`` stores of ``kvstore`` through ``Module.fit``, the launcher
``python -m mxnet_tpu_torch.launch``, ``parallel.dist`` (ranks, the
barrier watchdog, generations) and ``parallel.coordinator`` (leases,
``/cluster``, ``/fleet``) with the fit loops' and the router's hooks.
A process launched with ``MXTPU_ROLE=server`` serves the parameter store
inside ``import mxnet_tpu_torch`` and exits there (the import's last
statement), before user code could touch the card.

Entry points run on the card unless the caller passes ``device="cpu"``
(``ctx="cpu"`` for ``nd``); with no card and no explicit device they
raise :class:`MXNetError`.

    import mxnet_tpu_torch as mx
    x = mx.nd.zeros((2, 3))          # on the card
"""
from . import amp, context, passes, telemetry  # noqa: F401
from . import ndarray as nd  # noqa: F401
from . import model, predict, rtc  # noqa: F401
from . import callback, engine, io, lr_scheduler, metric, models  # noqa: F401
from . import initializer  # noqa: F401
from . import initializer as init  # noqa: F401
from .initializer import (Initializer, Load, Mixed, MSRAPrelu,  # noqa: F401
                          Normal, Orthogonal, Uniform, Xavier)
from .base import MXNetError, __version__  # noqa: F401
from .context import (Context, cpu, cpu_pinned, current_context,  # noqa: F401
                      gpu, num_devices, resolve_device, tpu)
from .base import AttrScope, NameManager  # noqa: F401
from . import engine, ops, random  # noqa: F401
from .ndarray import NDArray  # noqa: F401
from . import sparse  # noqa: F401
from .sparse import RowSparseNDArray  # noqa: F401
nd.sparse = sparse  # the reference surface: mx.nd.sparse.row_sparse_array
from . import checkpoint  # noqa: F401
from .model import FeedForward, load_checkpoint, save_checkpoint  # noqa: F401
from . import symbol  # noqa: F401
from . import symbol as sym  # noqa: F401
from .symbol import Group, Symbol, Variable  # noqa: F401
from . import executor  # noqa: F401
from .executor import Executor  # noqa: F401
from . import optimizer  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from . import kvstore  # noqa: F401
from . import kvstore as kv  # noqa: F401
from . import module  # noqa: F401
from . import module as mod  # noqa: F401
from .module import (BucketingModule, Module, PythonModule,  # noqa: F401
                     SequentialModule)
from . import rnn  # noqa: F401
from . import filesystem, image, recordio, storage  # noqa: F401
from . import monitor  # noqa: F401
from . import monitor as mon  # noqa: F401
from .monitor import Monitor  # noqa: F401
from . import executor_manager, faults, operator, profiler  # noqa: F401
from . import parallel, resource, test_utils, visualization  # noqa: F401
from . import visualization as viz  # noqa: F401
from .resource import ResourceManager, ResourceRequest  # noqa: F401
from . import kvstore_server  # noqa: F401

# Must be the last statement: a server-role process serves the parameter
# store here and exits without reaching user code (parity: MXNet's
# __init__.py importing kvstore_server at the bottom).
kvstore_server._init_kvstore_server_module()
