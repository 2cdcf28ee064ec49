"""trade-AId on PyTorch and CUDA: the port of the JAX package
``trade_aid_multimodal_transformer_tpu`` to an NVIDIA H100.

The layout mirrors the JAX package (``config/``, ``data/``, ``models/``,
``ops/``, ``train/``), so the counterpart of each module is found by its
path. The port imports ``torch`` and never ``jax``, and nothing of the JAX
package: the host layers it needs are copies kept here.
"""
