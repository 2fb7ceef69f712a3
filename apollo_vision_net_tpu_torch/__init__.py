"""apollo_vision_net_tpu_torch — PyTorch/CUDA port of the BEV perception
framework for one NVIDIA H100.

The JAX package ``apollo_vision_net_tpu`` is the reference this port is held
against; the port imports nothing of it (nor JAX). Plain tensor code is
PyTorch; every kernel that the JAX package wrote in Pallas is a hand-written
CUDA kernel under ``csrc/``, built with nvcc at first use. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``, where every kernel is
replaced by its plain PyTorch version.
"""
import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU: raise when there is none instead of quietly
    running on the CPU. Pass ``"cpu"`` to run the plain versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def set_f32_precision(conv_tf32: bool) -> None:
    """The port's f32 arithmetic on the card, a process-wide setting:
    matmuls in full f32 always, cuDNN's convolutions in TF32 only where
    ``conv_tf32`` (PyTorch's own default, TF32 convolutions everywhere, is
    not kept). ``build_model`` sets it for each model it puts on the card
    (``models.detector.conv_tf32``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = conv_tf32
