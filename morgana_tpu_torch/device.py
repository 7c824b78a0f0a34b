"""Device resolution for the port: the GPU unless the caller asks for the CPU.

Counterpart of ``morgana_tpu/platform.py``, keeping its fail-loudly
contract (``select_platform``): ``device=None`` means ``cuda``, and when no
GPU is present that is an error, not a silent move to the CPU. The CPU runs
only when asked for by name.

On the card the port computes f32 as IEEE f32, as on the CPU: resolving a
CUDA device turns off TF32 in cuDNN's convolutions, which PyTorch allows by
default, and in cuBLAS's products (:func:`use_ieee_f32`).
"""
import torch

__all__ = ['DeviceError', 'resolve_device', 'use_ieee_f32']


class DeviceError(RuntimeError):
    """Raised when the requested device is not available."""


def use_ieee_f32():
    """Turns TF32 off, process-wide, for cuDNN (PyTorch's default is on,
    which rounds a convolution's operands to 10 mantissa bits, forward and
    backward) and for cuBLAS's f32 products."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None):
    """Returns the ``torch.device`` to run on.

    ``None`` means ``'cuda'``. Any CUDA request raises :class:`DeviceError`
    when no GPU is present, naming ``device='cpu'`` as the way to run on the
    CPU. A CUDA device turns TF32 off (:func:`use_ieee_f32`).
    """
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise DeviceError(
            f'requested device {str(device)!r} but no CUDA device is available; '
            "pass device='cpu' to run on the CPU")
    if device.type not in ('cuda', 'cpu'):
        raise DeviceError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    if device.type == 'cuda':
        use_ieee_f32()
    return device
