"""The 4 x 8 FullyConnected net of ``tests/test_perl_binding.py`` in the
port, and its two oracles, for the port's amalgamation and Perl tests."""
import numpy as np

SHAPE = (4, 8)
JAX_TOL = 1e-5      # the JAX package's Predictor on the same numpy params


def tiny_net(tmp_path):
    """The 4 x 8 FullyConnected net of tests/test_perl_binding.py in the
    port, with numpy-seeded params: (json, params file, arrays)."""
    from mxnet_tpu_torch import ndarray as tnd
    from mxnet_tpu_torch import symbol as tsym

    data = tsym.Variable("data")
    net = tsym.FullyConnected(data, name="fc1", num_hidden=6)
    net = tsym.Activation(net, act_type="tanh")
    net = tsym.SoftmaxOutput(
        tsym.FullyConnected(net, name="fc2", num_hidden=3), name="softmax")
    rs = np.random.RandomState(11)
    arg = {"fc1_weight": rs.normal(0, 0.5, (6, 8)).astype(np.float32),
           "fc1_bias": rs.normal(0, 0.1, (6,)).astype(np.float32),
           "fc2_weight": rs.normal(0, 0.5, (3, 6)).astype(np.float32),
           "fc2_bias": rs.normal(0, 0.1, (3,)).astype(np.float32)}
    params = str(tmp_path / "m-0000.params")
    tnd.save(params, {f"arg:{k}": tnd.array(v, ctx="cpu")
                      for k, v in arg.items()})
    json_str = net.tojson()
    (tmp_path / "m-symbol.json").write_text(json_str)
    return json_str, params, arg


def oracles(json_str, params, arg, x):
    """The port's Predictor on the same JSON and bytes, and the JAX
    package's on the same numpy params."""
    import mxnet_tpu as jmx
    from mxnet_tpu.predict import Predictor as JPredictor

    from mxnet_tpu_torch.predict import Predictor

    with open(params, "rb") as f:
        blob = f.read()
    tp = Predictor(symbol_json_str=json_str, param_bytes=blob,
                   input_shapes={"data": SHAPE}, dev_type="cpu")
    tp.forward(data=x)
    jp = JPredictor(symbol_json_str=json_str,
                    arg_params={k: jmx.nd.array(v) for k, v in arg.items()},
                    aux_params={}, input_shapes={"data": SHAPE},
                    dev_type="cpu")
    jp.forward(data=x)
    return np.asarray(tp.get_output(0)), np.asarray(jp.get_output(0))
