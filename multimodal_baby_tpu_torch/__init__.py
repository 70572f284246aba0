"""multimodal_baby_tpu_torch: the PyTorch and CUDA port of
``multimodal_baby_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference; this package imports
``torch`` and never ``jax``. Its layout mirrors the JAX package's, so the
counterpart of ``multimodal_baby_tpu/<path>`` is ``multimodal_baby_tpu_torch/
<path>``:

- ``core``    config dataclasses and constants (the same fields and values
              as the JAX package's)
- ``ops``     hand-written Hopper kernels, each with its plain PyTorch version
- ``models``  the ResNeXt-50, ViT-B/14 and toy trunks, the text encoders,
              CVCL (flat and spatial similarity), losses, beam search
- ``data``    the on-device augment, the vocabulary, tokenizer and
              forced-choice trial datasets
- ``train``   AdamW over the trainable heads, the train and eval steps
- ``evaluation``  forced-choice evaluation and the linear probe
- ``api``     the five-call API (``load_model``) and the weight bridges
- ``cli``     the eval, parity and linear-decoding entry points
"""

__version__ = "0.1.0"
