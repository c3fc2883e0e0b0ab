"""PyTorch/CUDA port of keystone_tpu for one NVIDIA Hopper card.

The JAX package `keystone_tpu` is the reference; each module here names
its counterpart there and mirrors its path. Entry points take a
``device`` argument that defaults to ``"cuda"`` and raise when the card
is missing, unless the caller passes ``device="cpu"``. The featurizer's
kernels are hand-written CUDA (`csrc/`), built at first use.
"""
