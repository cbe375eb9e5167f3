"""catseg_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper) port of catseg_tpu.

The package keeps catseg_tpu's layout so the counterpart of any module is
easy to find:

- ``ops``: torch-native primitives in the JAX package's NHWC layouts;
- ``kernels``: one hand-written Hopper kernel per TPU kernel on the ported
  path (Triton or CUDA C++ under ``csrc/``), each beside its plain PyTorch
  version and a launch counter;
- ``core``: CLIP encoders, the cost aggregator and the CAT-Seg model;
- ``text``: class-name -> text-feature pipeline (tokenizer, BPE merges,
  templates);
- ``infer``: the sliding-window ``Predictor``;
- ``evaluation``: the confusion matrix and mIoU metrics;
- ``weights``: loading catseg_tpu parameters into the port.

Host-side code with no JAX in it (configs, tokenizer, templates, class
lists, the numpy checkpoint exporter) is copied into the port, which imports
neither jax nor anything of catseg_tpu and reads no file of it.  Entry points
(``build_catseg``, ``Predictor``) run on the card unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
