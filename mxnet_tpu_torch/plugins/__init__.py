"""Optional plugins (mirrors ``mxnet_tpu/plugins/__init__.py``; parity:
plugin/ in the reference — torch, caffe, warpctc, opencv, sframe,
compiled in via make flags).

Each plugin is a module that registers extra ops or functions when it
is imported:

- ``plugins.torch_plugin`` — ``TorchModule`` / ``TorchCriterion``: a
  ``torch.nn.Module`` or loss inside the graph, on the op's device
  (parity: plugin/torch/).  Imported with this package: the port always
  has torch.
- WarpCTC is a built-in op (``ops/ctc.py``) — no plugin needed.
- ``plugins.opencv_plugin`` — the plugin/opencv surface (``imdecode``,
  ``resize``, ``copyMakeBorder``, the crop and normalise helpers,
  ``ImageListIter``) over cv2 where it imports, else over the port's own
  decode path and numpy.
- Caffe / SFrame have no backing libraries here; importing them raises
  (the reference gates them behind build flags the same way).

The package's ``__init__`` does not import this one, as in the
reference: ``import mxnet_tpu_torch.plugins`` does.
"""


from . import torch_plugin  # noqa: F401,E402

torch_available = True   # the port always has torch
