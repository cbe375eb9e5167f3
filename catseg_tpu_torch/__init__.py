"""catseg_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper) port of catseg_tpu.

The package keeps catseg_tpu's layout so the counterpart of any module is
easy to find:

- ``ops``: torch-native primitives in the JAX package's NHWC layouts;
- ``kernels``: one hand-written Hopper kernel per TPU kernel on the ported
  path (Triton or CUDA C++ under ``csrc/``), each beside its plain PyTorch
  version and a launch counter;
- ``core``: CLIP encoders, the cost aggregator and the CAT-Seg model;
- ``text``: class-name -> text-feature pipeline;
- ``infer``: the sliding-window ``Predictor``;
- ``weights``: loading catseg_tpu parameters into the port.

Host-side code with no JAX in it (configs, tokenizer, templates, the numpy
checkpoint exporter) is imported from catseg_tpu rather than copied.  This
package never imports jax.
"""

__version__ = "0.1.0"
