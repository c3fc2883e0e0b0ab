"""Device selection and the float32 precision contract.

Counterpart of the JAX package's mesh/backend selection
(`keystone_tpu/parallel/mesh.py`) for one card and no mesh.

Every entry point of the port takes a ``device`` argument that defaults
to ``"cuda"``. A request for the card when none is present raises: the
port never carries on on the CPU unless the caller asked for the CPU
(``device="cpu"``, as the tests do).

Precision: the JAX package pins ``Precision.HIGHEST`` on the Convolver
fold (`nodes/images/core.py:88-93`), the ZCA steps
(`pipelines/random_patch_cifar.py:159-169`) and BCD
(`nodes/learning/block_ls.py:49`). Their counterpart on the card is true
float32: TF32 is switched off for cuBLAS matmuls and for cuDNN
convolutions (cuDNN's TF32 is on by default).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The ``torch.device`` for ``device`` (None means ``"cuda"``).

    Raises RuntimeError when the card is asked for and CUDA is not
    available. Selecting a CUDA device also sets the float32 contract
    (`set_fp32_precision`)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU")
        set_fp32_precision()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def set_fp32_precision() -> None:
    """True float32 for every fp32 matmul and convolution (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
