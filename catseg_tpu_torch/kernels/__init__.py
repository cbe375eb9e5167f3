"""Hand-written Hopper kernels of the ported path, each beside its plain
PyTorch version and a launch counter (see ``_build``).  Importing this
package builds nothing: kernels are built at first launch."""
