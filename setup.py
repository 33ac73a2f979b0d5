"""Build script for the native extension.

    python setup.py build_ext --inplace       # or: make native
"""

from setuptools import Extension, setup

setup(
    name="raweditor_tpu",
    version="0.1.0",
    packages=[
        "raweditor_tpu",
        "raweditor_tpu.ops",
        "raweditor_tpu.raw",
        "raweditor_tpu.catalog",
        "raweditor_tpu.pipeline",
        "raweditor_tpu.parallel",
        "raweditor_tpu.utils",
        "raweditor_tpu.native",
        "raweditor_tpu_torch",
        "raweditor_tpu_torch.ops",
        "raweditor_tpu_torch.raw",
        "raweditor_tpu_torch.pipeline",
        "raweditor_tpu_torch.parallel",
        "raweditor_tpu_torch.utils",
    ],
    ext_modules=[
        Extension(
            "raweditor_tpu.native._rawkit",
            sources=["raweditor_tpu/native/rawkit.cpp"],
            extra_compile_args=["-O3", "-std=c++17", "-Wall"],
            language="c++",
        )
    ],
)
