"""multimodal_baby_tpu_torch: the PyTorch and CUDA port of
``multimodal_baby_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference; this package imports
``torch`` and never ``jax``. Its layout mirrors the JAX package's, so the
counterpart of ``multimodal_baby_tpu/<path>`` is ``multimodal_baby_tpu_torch/
<path>``:

- ``core``    config dataclasses and constants (the same fields and values
              as the JAX package's)
- ``ops``     hand-written Hopper kernels, each with its plain PyTorch version
- ``models``  the ResNeXt-50 trunk, the embedding text encoder, CVCL, losses
- ``data``    the on-device augment
- ``train``   AdamW over the trainable heads, the train and eval steps
- ``api``     the weight bridge from the JAX package's parameter trees

The first slice covers the CVCL ResNeXt-50 + embedding train step.
"""

__version__ = "0.1.0"
