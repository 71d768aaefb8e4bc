#!/usr/bin/env python
"""Package build for mxnet_tpu (parity: tools/pip_package in the
reference — the C ABI libraries ship as package data, like the
reference wheel bundles libmxnet.so).

    python setup.py bdist_wheel      # platform wheel incl. native libs
    python setup.py sdist            # source dist (native SOURCES only)

Binary commands (bdist_wheel / install / develop) rebuild any missing
native library from src/ first; metadata-only commands (sdist, egg_info,
--help) need no toolchain.
"""
import glob
import os
import subprocess
import sys

from setuptools import find_packages, setup
from setuptools.dist import Distribution

HERE = os.path.dirname(os.path.abspath(__file__))

_CORE_LIBS = ("libmxtpu.so", "libmxtpu_capi.so", "libmxtpu_predict.so")
_BINARY_CMDS = {"bdist_wheel", "bdist", "install", "develop", "build",
                "build_ext"}


def _ensure_native_libs():
    """Build any missing C ABI library (fresh clone: mxnet_tpu/lib is
    generated, not tracked; the Makefile's default target covers only
    the host engine, so name the capi/predict targets explicitly)."""
    libdir = os.path.join(HERE, "mxnet_tpu", "lib")
    if not all(os.path.exists(os.path.join(libdir, lib))
               for lib in _CORE_LIBS):
        subprocess.run(
            ["make", "-C", os.path.join(HERE, "src"),
             "all", "capi", "predict"], check=True)
    missing = [lib for lib in _CORE_LIBS
               if not os.path.exists(os.path.join(libdir, lib))]
    if missing:
        raise RuntimeError(
            f"native libraries {missing} missing after `make -C src`; "
            "build the runtime before packaging")


if _BINARY_CMDS.intersection(sys.argv[1:]):
    _ensure_native_libs()


class _BinaryDistribution(Distribution):
    """The wheel carries platform-specific .so files — force a platform
    tag so pip never installs an x86-64 Linux wheel elsewhere."""

    def has_ext_modules(self):
        return True


def _readme():
    path = os.path.join(HERE, "README.md")
    if os.path.exists(path):
        with open(path) as f:
            return f.read()
    return ""


setup(
    name="mxnet-tpu",
    version="0.9.4",  # tracks the reference surface this package mirrors
    description="TPU-native deep learning framework with the MXNet "
                "v0.9 API surface (JAX/XLA/Pallas compute, C++ runtime)",
    long_description=_readme(),
    long_description_content_type="text/markdown",
    packages=find_packages(include=["mxnet_tpu", "mxnet_tpu.*",
                                    "mxnet_tpu_torch", "mxnet_tpu_torch.*"]),
    # the PyTorch port's CUDA kernels and C ABIs ship as sources: nvcc and
    # g++ build them at first use (mxnet_tpu_torch/ops/_build.py); its
    # Perl binding builds with perl Makefile.PL; the port lint reads its
    # allowlist
    package_data={"mxnet_tpu": ["lib/*.so"],
                  "mxnet_tpu_torch": ["ops/csrc/*.cu", "csrc/*.cc",
                                      "csrc/*.h", "csrc/clients/*",
                                      "bindings/perl/Makefile.PL",
                                      "bindings/perl/*.xs",
                                      "bindings/perl/lib/*.pm",
                                      "analysis/allowlist.json"]},
    include_package_data=True,
    distclass=_BinaryDistribution,
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
    extras_require={
        "io": ["pillow"],
        "viz": ["graphviz"],
    },
)
