"""ADEL-FL on PyTorch and CUDA: the port of the JAX package ``repro``.

The subpackages mirror ``repro`` module for module (``core``, ``data``,
``fl``, ``kernels``, ``models``, ``obs``) so each counterpart is easy to
find. The port imports ``torch``, numpy and scipy, and never JAX or
``repro``.

Entry points (``fl.server.run_federated``, ``fl.runtime.RoundRuntime``,
``fl.backends.make_backend`` and its backends, ``core.scheduler.solve``;
``fl.spec.ExecSpec`` selects the backend, ``obs`` records telemetry) run
on the card by default (``device="cuda"``) and raise when there is none,
unless the caller passes ``device="cpu"``. Every Eq. 5 fold goes through
the hand-written CUDA kernels of :mod:`repro_torch.kernels.adel_agg` on a
CUDA tensor; the plain PyTorch versions run only on CPU tensors.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
