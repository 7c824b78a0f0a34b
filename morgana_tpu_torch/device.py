"""Device resolution for the port: the GPU unless the caller asks for the CPU.

Counterpart of ``morgana_tpu/platform.py``, keeping its fail-loudly
contract (``select_platform``): ``device=None`` means ``cuda``, and when no
GPU is present that is an error, not a silent move to the CPU. The CPU runs
only when asked for by name.
"""
import torch

__all__ = ['DeviceError', 'resolve_device']


class DeviceError(RuntimeError):
    """Raised when the requested device is not available."""


def resolve_device(device=None):
    """Returns the ``torch.device`` to run on.

    ``None`` means ``'cuda'``. Any CUDA request raises :class:`DeviceError`
    when no GPU is present, naming ``device='cpu'`` as the way to run on the
    CPU.
    """
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise DeviceError(
            f'requested device {str(device)!r} but no CUDA device is available; '
            "pass device='cpu' to run on the CPU")
    if device.type not in ('cuda', 'cpu'):
        raise DeviceError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return device
