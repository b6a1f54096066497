"""Device resolution for the port's entry points.

The counterpart of ``kuberay_tpu/utils/platform.py``: where the JAX
package pins ``jax_platforms``, the port resolves one explicit torch
device.  The card is the default, and a missing card is an error: nothing
carries on quietly on the CPU unless the caller asked for it.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``, checked.

    ``"cuda"`` (the default) raises when no CUDA device is present; pass
    ``"cpu"`` to run the plain PyTorch paths.  ``"meta"`` is accepted for
    shape-only construction.  On CUDA this also turns TF32 off for both
    float32 matmuls and cuDNN convolutions, so float32 work on the card
    keeps full float32 precision, as the JAX reference computes it.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {device!r} (cuda, cpu or meta)")
    return dev
