"""morgana_tpu_torch — the PyTorch and CUDA port of morgana_tpu for NVIDIA Hopper.

The JAX package ``morgana_tpu`` is the reference; this package keeps its
module names and parameter names, so one ``epoch_{N}.npz`` checkpoint drives
both. Its kernels are written by hand for ``sm_90a`` under ``csrc/`` and
built at first use (``_build.py``); each has a plain PyTorch version beside
it, which runs for tensors on the CPU. Entry points run on the GPU unless the
caller passes ``device='cpu'`` (``device.py``).

It serves ``LSTMAcousticModel`` (``models/rnn_spss.py``), ``F0Model``
(``models/f0_test_model.py``) and ``DurationModel``
(``models/duration_model.py``) through
:class:`morgana_tpu_torch.serve.InferenceEngine` and trains them through
:class:`morgana_tpu_torch.experiment_builder.ExperimentBuilder`
(``python -m morgana_tpu_torch.models.rnn_spss``, ``.f0_test_model``,
``.duration_model``).
"""
__version__ = '0.1.0'

from morgana_tpu_torch.device import DeviceError, resolve_device

__all__ = ['DeviceError', 'resolve_device', '__version__']
