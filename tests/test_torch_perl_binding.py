"""The port's Perl binding (``mxnet_tpu_torch/bindings/perl``): the XS
extension built against the port's predict library — the one
``libinfo.find_lib_path("predict")`` builds, and an amalgamated build
(``python -m mxnet_tpu_torch.amalgamate --predict``) passed to
``Makefile.PL`` — runs ``MXNetTPU::Predictor`` on the CPU (``dev_type``
1) over ``tests/test_perl_binding.py``'s 4 x 8 FullyConnected net.  Both
of its paths (a Perl array, packed float32 bytes) equal the port's
``Predictor`` exactly and the JAX package's within 1e-5 on the same
params, carried across as numpy arrays.  The client's embedded
interpreter runs with a ``PYTHONPATH`` whose first entry holds ``jax``
and ``mxnet_tpu`` packages that raise on import.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from torch_tiny_predict import JAX_TOL, SHAPE, oracles, tiny_net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PERL_CLIENT = """
use strict; use warnings;
use lib "%(blib)s/lib", "%(blib)s/arch";
use MXNetTPU;
my $p = MXNetTPU::Predictor->new(
    symbol_file => "%(prefix)s-symbol.json",
    params_file => "%(prefix)s-0000.params",
    input_key   => "data",
    input_shape => [4, 8],
    dev_type    => 1);
my @x = map { $_ / 32.0 } 0 .. 31;
my $out = $p->predict([@x]);
my $raw = $p->predict_packed(pack("f<*", @x));
print "shape: @{$p->output_shape}\\n";
open my $fh, '>:raw', "%(out)s" or die "cannot write: $!";
print $fh pack("f<*", @$out), $raw;
close $fh;
"""


def _have_perl_toolchain():
    if shutil.which("perl") is None or shutil.which("make") is None or \
            shutil.which("g++") is None:
        return False
    r = subprocess.run(["perl", "-MExtUtils::MakeMaker", "-e", "1"],
                       capture_output=True)
    return r.returncode == 0


pytestmark = pytest.mark.skipif(not _have_perl_toolchain(),
                                reason="perl + MakeMaker + g++ unavailable")


def _amalgamated_lib(tmp_path):
    from mxnet_tpu_torch import amalgamate

    src = str(tmp_path / "all-predict.cc")
    lib = str(tmp_path / "libmxtpu_predict_amal.so")
    amalgamate.amalgamate(src, predict=True)
    r = subprocess.run(amalgamate.build_command(src, lib, predict=True),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return lib


def _build_extension(tmp_path, lib_args):
    build = tmp_path / "perl"
    shutil.copytree(os.path.join(REPO, "mxnet_tpu_torch", "bindings",
                                 "perl"), build)
    env = dict(os.environ, PYTHON=sys.executable)
    r = subprocess.run(["perl", "Makefile.PL", REPO, *lib_args], cwd=build,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    r = subprocess.run(["make"], cwd=build, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return build


@pytest.mark.parametrize("library", ["libinfo", "amalgamated"])
def test_perl_client_matches_both_predictors(tmp_path, library):
    from mxnet_tpu_torch import libinfo

    lib_args = [_amalgamated_lib(tmp_path)] if library == "amalgamated" \
        else []
    build = _build_extension(tmp_path, lib_args)
    so = build / "blib" / "arch" / "auto" / "MXNetTPU" / "MXNetTPU.so"
    linked = subprocess.run(["ldd", str(so)], capture_output=True,
                            text=True).stdout
    want = lib_args[0] if lib_args else libinfo.find_lib_path("predict")
    assert want in linked, linked

    json_str, params, arg = tiny_net(tmp_path)
    prefix = str(tmp_path / "m")
    out = str(tmp_path / "out.f32")
    script = tmp_path / "client.pl"
    script.write_text(PERL_CLIENT % {"blib": str(build / "blib"),
                                     "prefix": prefix, "out": out})
    poison = tmp_path / "poison"
    for pkg in ("jax", "mxnet_tpu"):
        (poison / pkg).mkdir(parents=True)
        (poison / pkg / "__init__.py").write_text(
            f"raise ImportError('the port imported {pkg}')\n")
    env = libinfo.client_env()
    env["PYTHONPATH"] = str(poison) + os.pathsep + env["PYTHONPATH"]
    r = subprocess.run(["perl", str(script)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, f"stdout: {r.stdout}\nstderr: {r.stderr}"
    assert r.stdout.strip().splitlines()[0] == "shape: 4 3", r.stdout
    got = np.fromfile(out, np.float32).reshape(2, SHAPE[0], 3)

    x = (np.arange(32, dtype=np.float32) / 32.0).reshape(SHAPE)
    port, jax = oracles(json_str, params, arg, x)
    for g in got:                     # the array path, the packed path
        np.testing.assert_array_equal(g, port)
        np.testing.assert_allclose(g, jax, rtol=0, atol=JAX_TOL)
